from .convert import retriever_state_dict_from_jax
from .encoder import TransformerEncoder
from .retriever import MhopRetriever, MultiVectorCtxEncoder, ProjectionHead

__all__ = ["MhopRetriever", "MultiVectorCtxEncoder", "ProjectionHead",
           "TransformerEncoder", "retriever_state_dict_from_jax"]
