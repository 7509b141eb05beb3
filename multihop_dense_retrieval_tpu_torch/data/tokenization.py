"""Host-side tokenization: fixed-shape numpy encodes plus the raw
(special-token-free) ids the search engine assembles hop-2 queries from.

A numpy-only copy of the JAX package's ``data/tokenization.py``
(``TokenizerSpec``, the shared encode layer and ``HashTokenizer``); the
two must produce identical ids, which tests/test_torch_beam.py checks.

Sequence layouts (matching HF):
  roberta single: <s> x </s>                     pad=<pad>
  roberta pair:   <s> a </s> </s> b </s>
  bert single:    [CLS] x [SEP]                  (+ token_type_ids)
  bert pair:      [CLS] a [SEP] b [SEP]          (types 0…0 1…1)
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenizerSpec:
    """Special-token layout shared by host tokenization and on-device assembly."""

    cls_id: int
    sep_id: int
    pad_id: int
    vocab_size: int
    roberta_style: bool = True  # True: pair sep is `</s> </s>`; False: BERT
    mask_id: Optional[int] = None

    @property
    def num_special_pair(self) -> int:
        return 4 if self.roberta_style else 3

    @property
    def num_special_single(self) -> int:
        return 2


class _Base:
    spec: TokenizerSpec

    sep_token: str = "[SEP]"
    marker_token: str = "[unused1]"

    def tokenize_ids(self, text: str) -> List[int]:
        raise NotImplementedError

    def subtokens(self, word: str) -> List[str]:
        raise NotImplementedError

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        raise NotImplementedError

    def encode_one(self, text: str, max_len: int) -> Dict[str, np.ndarray]:
        s = self.spec
        if max_len < s.num_special_single:
            raise ValueError(f"max_len {max_len} cannot fit the "
                             f"{s.num_special_single} special tokens")
        body = self.tokenize_ids(text)[: max_len - s.num_special_single]
        ids = [s.cls_id] + body + [s.sep_id]
        return self._pad(ids, len(ids), max_len)

    def encode_one_augmented(self, text: str, max_len: int) -> Dict[str, np.ndarray]:
        """Short questions padded with [MASK] tokens up to max_len."""
        s = self.spec
        body = self.tokenize_ids(text)[: max_len - s.num_special_single]
        fill = max_len - s.num_special_single - len(body)
        if fill > 0 and s.mask_id is not None:
            body = body + [s.mask_id] * fill
        ids = [s.cls_id] + body + [s.sep_id]
        return self._pad(ids, len(ids), max_len)

    def encode_pair(self, a: str, b: str, max_len: int) -> Dict[str, np.ndarray]:
        s = self.spec
        if max_len < s.num_special_pair:
            raise ValueError(f"max_len {max_len} cannot fit the "
                             f"{s.num_special_pair} special tokens")
        ta = self.tokenize_ids(a)
        tb = self.tokenize_ids(b)
        budget = max_len - s.num_special_pair
        # longest-first truncation; ties remove from the pair side
        while len(ta) + len(tb) > budget:
            if len(ta) > len(tb):
                ta = ta[:-1]
            else:
                tb = tb[:-1]
        if s.roberta_style:
            ids = [s.cls_id] + ta + [s.sep_id, s.sep_id] + tb + [s.sep_id]
            type_split = None
        else:
            ids = [s.cls_id] + ta + [s.sep_id] + tb + [s.sep_id]
            type_split = len(ta) + 2
        out = self._pad(ids, len(ids), max_len)
        if type_split is not None:
            types = np.zeros(max_len, dtype=np.int32)
            types[type_split:len(ids)] = 1
            out["token_type_ids"] = types
        return out

    def encode_batch_one(self, texts: Sequence[str], max_len: int) -> Dict[str, np.ndarray]:
        rows = [self.encode_one(t, max_len) for t in texts]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}

    def encode_batch_pair(self, pairs: Sequence, max_len: int) -> Dict[str, np.ndarray]:
        rows = [self.encode_pair(a, b, max_len) for a, b in pairs]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}

    def raw_ids_padded(self, text: str, max_len: int):
        """(ids[max_len], length) without specials — feeds on-device assembly."""
        body = self.tokenize_ids(text)[:max_len]
        ids = np.full(max_len, self.spec.pad_id, dtype=np.int32)
        ids[: len(body)] = body
        return ids, len(body)

    def _pad(self, ids: List[int], n: int, max_len: int) -> Dict[str, np.ndarray]:
        s = self.spec
        out = np.full(max_len, s.pad_id, dtype=np.int32)
        out[:n] = ids
        mask = np.zeros(max_len, dtype=np.int32)
        mask[:n] = 1
        return {"input_ids": out, "attention_mask": mask}


class HashTokenizer(_Base):
    """Deterministic word-hash tokenizer (tests / synthetic corpora): splits
    on whitespace, lowercases, hashes each word into [n_special, vocab)."""

    N_SPECIAL = 4  # 0:<s> 1:<pad> 2:</s> 3:<unk>

    def __init__(self, vocab_size: int = 50265, roberta_style: bool = True):
        if roberta_style:
            spec = TokenizerSpec(cls_id=0, sep_id=2, pad_id=1,
                                 vocab_size=vocab_size, roberta_style=True,
                                 mask_id=vocab_size - 1)
        else:
            spec = TokenizerSpec(cls_id=101, sep_id=102, pad_id=0,
                                 vocab_size=vocab_size, roberta_style=False,
                                 mask_id=103)
        self.spec = spec
        self._lo = 110 if not roberta_style else self.N_SPECIAL

    MARKER_ID = 3  # reuses the <unk> slot as [unused1] (tests only)

    def _hash_id(self, w: str) -> int:
        h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
        hi = self.spec.vocab_size - (1 if self.spec.roberta_style else 0)
        return self._lo + h % (hi - self._lo)

    def tokenize_ids(self, text: str) -> List[int]:
        return [self._hash_id(w) for w in text.lower().split()]

    def subtokens(self, word: str) -> List[str]:
        return [word.lower()]

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        out = []
        for t in tokens:
            if t == self.sep_token:
                out.append(self.spec.sep_id)
            elif t == self.marker_token:
                out.append(self.MARKER_ID)
            else:
                out.append(self._hash_id(t))
        return out


class HFTokenizer(_Base):
    """A HF fast tokenizer from a local directory (no network).  Keeps the
    fixed-shape interface; the subword segmentation is HF's.
    ``transformers`` is imported here only: the port needs it for this
    class alone."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.spec = TokenizerSpec(
            cls_id=self.tok.cls_token_id,
            sep_id=self.tok.sep_token_id,
            pad_id=self.tok.pad_token_id,
            vocab_size=self.tok.vocab_size,
            roberta_style=self.tok.cls_token_id == 0,   # roberta: <s>=0
            mask_id=self.tok.mask_token_id,
        )

    def tokenize_ids(self, text: str) -> List[int]:
        return self.tok(text, add_special_tokens=False)["input_ids"]

    def subtokens(self, word: str) -> List[str]:
        return self.tok.tokenize(word)

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return self.tok.convert_tokens_to_ids(list(tokens))
