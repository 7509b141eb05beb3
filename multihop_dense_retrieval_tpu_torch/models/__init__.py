from .convert import reader_state_dict_from_jax, retriever_state_dict_from_jax
from .encoder import TransformerEncoder
from .reader import QAReader
from .retriever import MhopRetriever, MultiVectorCtxEncoder, ProjectionHead

__all__ = ["MhopRetriever", "MultiVectorCtxEncoder", "ProjectionHead",
           "QAReader", "TransformerEncoder", "reader_state_dict_from_jax",
           "retriever_state_dict_from_jax"]
