from .convert import (reader_state_dict_from_jax,
                      retriever_state_dict_from_jax,
                      unified_state_dict_from_jax,
                      unified_state_dict_from_reference)
from .encoder import TransformerEncoder
from .reader import QAReader
from .retriever import (MhopRetriever, MultiVectorCtxEncoder, ProjectionHead,
                        UnifiedRetriever)

__all__ = ["MhopRetriever", "MultiVectorCtxEncoder", "ProjectionHead",
           "QAReader", "TransformerEncoder", "UnifiedRetriever",
           "reader_state_dict_from_jax", "retriever_state_dict_from_jax",
           "unified_state_dict_from_jax",
           "unified_state_dict_from_reference"]
