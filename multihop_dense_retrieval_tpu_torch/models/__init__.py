from .convert import retriever_state_dict_from_jax
from .encoder import TransformerEncoder
from .retriever import MhopRetriever, ProjectionHead

__all__ = ["MhopRetriever", "ProjectionHead", "TransformerEncoder",
           "retriever_state_dict_from_jax"]
