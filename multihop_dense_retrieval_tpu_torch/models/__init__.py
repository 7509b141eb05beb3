from .convert import (reader_state_dict_from_jax,
                      retriever_state_dict_from_jax,
                      unified_state_dict_from_jax,
                      unified_state_dict_from_reference)
from .encoder import TransformerEncoder
from .reader import QAReader
from .retriever import (MhopRetriever, MultiVectorCtxEncoder, NQRetriever,
                        ProjectionHead, SingleRetriever, UnifiedRetriever)

__all__ = ["MhopRetriever", "MultiVectorCtxEncoder", "NQRetriever",
           "ProjectionHead", "QAReader", "SingleRetriever",
           "TransformerEncoder", "UnifiedRetriever",
           "reader_state_dict_from_jax", "retriever_state_dict_from_jax",
           "unified_state_dict_from_jax",
           "unified_state_dict_from_reference"]
