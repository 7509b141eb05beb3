from .corpus import Corpus, TokenizedCorpus, nfd_normalize
from .tokenization import HashTokenizer, HFTokenizer, TokenizerSpec

__all__ = ["Corpus", "HashTokenizer", "HFTokenizer", "TokenizedCorpus",
           "TokenizerSpec", "nfd_normalize"]
