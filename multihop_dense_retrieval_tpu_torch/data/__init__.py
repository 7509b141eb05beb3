from .tokenization import HashTokenizer, TokenizerSpec

__all__ = ["HashTokenizer", "TokenizerSpec"]
