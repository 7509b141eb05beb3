from .corpus import Corpus, TokenizedCorpus, nfd_normalize
from .loader import BatchLoader
from .mhop_dataset import MhopDataset, mhop_collate
from .tokenization import HashTokenizer, HFTokenizer, TokenizerSpec
from .unified_dataset import FeverDataset, FeverSampler, UnifiedDataset

__all__ = ["BatchLoader", "Corpus", "FeverDataset", "FeverSampler",
           "HashTokenizer", "HFTokenizer", "MhopDataset", "TokenizedCorpus",
           "TokenizerSpec", "UnifiedDataset", "mhop_collate", "nfd_normalize"]
