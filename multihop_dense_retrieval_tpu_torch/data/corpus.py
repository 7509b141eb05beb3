"""Corpus handling: the id → title/text table and the pre-tokenized store.

The port's own copy of the JAX package's ``data/corpus.py`` (same files on
disk, same normalisation):

  * ``Corpus``          — host-side doc table, with the reference's NFD
                          title normalisation and empty-text → title
                          substitution for encoding;
  * ``TokenizedCorpus`` — every document's text tokenized once (no
                          specials) into a fixed (N, L) id matrix and
                          lengths, from which the engine assembles hop-2
                          queries on the device.

The empty-text flag doubles as the hop-1 patch: chains must not start at
an empty document.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import unicodedata
from typing import Dict, List, Optional

import numpy as np

from .tokenization import _Base as Tokenizer


def nfd_normalize(text: str) -> str:
    """The reference NFD-normalizes titles everywhere."""
    return unicodedata.normalize("NFD", text)


class Corpus:
    """In-memory doc table.  ``docs[i] = {"title", "text"}``."""

    def __init__(self, docs: List[Dict[str, str]]):
        self.docs = docs

    @classmethod
    def from_jsonl(cls, path: str, max_docs: Optional[int] = None) -> "Corpus":
        docs = []
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                r = json.loads(line)
                docs.append({"title": nfd_normalize(r["title"].strip()),
                             "text": r["text"].strip()})
                if max_docs and len(docs) >= max_docs:
                    break
        return cls(docs)

    @classmethod
    def from_id2doc(cls, path: str) -> "Corpus":
        """Load an id2doc.json: dict-of-lists ``{idx: (title, text[, intro])}``
        or dict-of-dicts.  Titles get the same NFD + strip as
        ``from_jsonl``, so title matches agree across the two load paths."""
        with open(path) as f:
            table = json.load(f)
        docs = [None] * len(table)
        for k, v in table.items():
            if isinstance(v, (list, tuple)):
                title, text = v[0], v[1]
            else:
                title, text = v["title"], v["text"]
            docs[int(k)] = {"title": nfd_normalize(title.strip()),
                            "text": text}
        return cls(docs)

    def __len__(self):
        return len(self.docs)

    def __getitem__(self, i: int) -> Dict[str, str]:
        return self.docs[i]

    def save_id2doc(self, path: str):
        with open(path, "w") as f:
            json.dump({str(i): {"title": d["title"], "text": d["text"]}
                       for i, d in enumerate(self.docs)}, f)

    def encode_text(self, i: int) -> str:
        """Body text used for encoding; empty text falls back to the title."""
        d = self.docs[i]
        return d["text"] if d["text"].strip() else d["title"]

    def is_empty(self, i: int) -> bool:
        return not self.docs[i]["text"].strip()


class TokenizedCorpus:
    """(N, L) doc-text token ids (no specials) + lengths + empty flags."""

    def __init__(self, text_ids: np.ndarray, text_lens: np.ndarray,
                 title_ids: np.ndarray, title_lens: np.ndarray,
                 empty: np.ndarray):
        self.text_ids = text_ids        # (N, Lt) int32
        self.text_lens = text_lens      # (N,)  int32
        self.title_ids = title_ids      # (N, Lh) int32
        self.title_lens = title_lens    # (N,)  int32
        self.empty = empty              # (N,)  bool — text was empty

    @classmethod
    def build(cls, corpus: Corpus, tokenizer: Tokenizer,
              max_text_len: int = 300, max_title_len: int = 64,
              num_workers: int = 8) -> "TokenizedCorpus":
        """Tokenize the whole corpus once, with threads (HF fast tokenizers
        release the GIL)."""
        n = len(corpus)
        text_ids = np.full((n, max_text_len), tokenizer.spec.pad_id, np.int32)
        title_ids = np.full((n, max_title_len), tokenizer.spec.pad_id,
                            np.int32)
        text_lens = np.zeros(n, np.int32)
        title_lens = np.zeros(n, np.int32)
        empty = np.zeros(n, bool)

        def work(i):
            empty[i] = corpus.is_empty(i)
            text_ids[i], text_lens[i] = tokenizer.raw_ids_padded(
                corpus.encode_text(i), max_text_len)
            title_ids[i], title_lens[i] = tokenizer.raw_ids_padded(
                corpus[i]["title"].strip(), max_title_len)

        if num_workers > 1 and n > 256:
            with cf.ThreadPoolExecutor(num_workers) as pool:
                list(pool.map(work, range(n), chunksize=512))
        else:
            for i in range(n):
                work(i)
        return cls(text_ids, text_lens, title_ids, title_lens, empty)

    def save(self, path: str):
        """Token ids are stored as uint16; a larger id raises instead of
        wrapping."""
        hi = max(int(self.text_ids.max(initial=0)),
                 int(self.title_ids.max(initial=0)))
        if hi > np.iinfo(np.uint16).max:
            raise ValueError(
                f"token id {hi} exceeds uint16 storage; vocabularies >=65536 "
                "need a wider on-disk dtype")
        np.savez_compressed(
            path, text_ids=self.text_ids.astype(np.uint16),
            text_lens=self.text_lens, title_ids=self.title_ids.astype(np.uint16),
            title_lens=self.title_lens, empty=self.empty)

    @classmethod
    def load(cls, path: str,
             token_dtype: "np.dtype" = np.int32) -> "TokenizedCorpus":
        """``token_dtype=np.uint16`` keeps ids at their on-disk width (the
        serving engine widens them after its per-beam gather)."""
        z = np.load(path)
        return cls(z["text_ids"].astype(token_dtype, copy=False),
                   z["text_lens"],
                   z["title_ids"].astype(token_dtype, copy=False),
                   z["title_lens"], z["empty"])
