"""Plain reference of the reader's host side: the hash tokenizer, the
reader's features of a (question, chain) item, the best span, and the
answer text of a span.

Frozen copies of what the reference needs of the program's helpers (the
hash tokenizer of ``data/tokenization.py``, the eval features of
``data/qa_dataset.py`` with MDR's context layout, the span band of
``train/qa.py``, ``decode_answer``), written for the eval path only, so
that a change in the program shows as a difference.  It imports nothing
of the program.

Context layout (MDR's ``qa_dataset.py``): ``"yes no [SEP] " + " [SEP] "
.join(title + " " + " ".join("[unused1] " + sent))``; the features are
``[CLS] question [SEP] context [SEP]``, the context's tokens after the
question's segment, the paragraph mask over the context, the sentence
markers' positions.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List

import numpy as np
import torch

SEP_TOKEN, MARKER_TOKEN = "[SEP]", "[unused1]"


class HashTokenizer:
    """BERT-style specials (CLS 101, SEP 102, PAD 0), the marker on id 3,
    each lowercased whitespace word hashed (md5, first 4 bytes little
    endian) into [110, vocab)."""

    cls_id, sep_id, pad_id, marker_id = 101, 102, 0, 3

    def __init__(self, vocab_size: int):
        self.vocab = vocab_size

    def word_id(self, w: str) -> int:
        h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
        return 110 + h % (self.vocab - 110)

    def token_id(self, t: str) -> int:
        if t == SEP_TOKEN:
            return self.sep_id
        if t == MARKER_TOKEN:
            return self.marker_id
        return self.word_id(t)


def _context(passages: List[Dict]):
    parts = []
    for para in passages:
        sents = " ".join(f"{MARKER_TOKEN} {s.strip()}" for s in para["sents"])
        parts.append(f"{para['title'].strip()} {sents}")
    text = "yes no [SEP] " + " [SEP] ".join(parts)
    words = text.split()
    pieces, tok_to_orig, starts = [], [], []
    for i, w in enumerate(words):
        if w == MARKER_TOKEN:
            starts.append(len(pieces))
        pieces.append(w if w in (SEP_TOKEN, MARKER_TOKEN) else w.lower())
        tok_to_orig.append(i)
    return words, pieces, tok_to_orig, starts


def features(tok: HashTokenizer, question: str, passages: List[Dict],
             max_len: int = 512, max_q: int = 64, max_sents: int = 40):
    """(features, meta) of one item, the features ``max_len`` wide."""
    if question.endswith("?"):
        question = question[:-1]
    q = [w.lower() for w in question.split()][:max_q]
    words, pieces, tok_to_orig, starts = _context(passages)
    off = len(q) + 2
    pieces = pieces[:max_len - off - 1]
    ids = ([tok.cls_id] + [tok.word_id(w) for w in q] + [tok.sep_id]
           + [tok.token_id(t) for t in pieces] + [tok.sep_id])
    n = len(ids)
    f = {k: np.zeros(max_len, np.int32) for k in
         ("input_ids", "attention_mask", "token_type_ids", "paragraph_mask")}
    f["input_ids"][:n] = ids
    f["attention_mask"][:n] = 1
    f["token_type_ids"][off:n] = 1
    f["paragraph_mask"][off:n - 1] = 1
    kept = [s for s in starts if s < len(pieces)][:max_sents]
    f["sent_offsets"] = np.zeros(max_sents, np.int32)
    f["sent_mask"] = np.zeros(max_sents, np.int32)
    f["sent_offsets"][:len(kept)] = np.asarray(kept, np.int32) + off
    f["sent_mask"][:len(kept)] = 1
    meta = {"off": off, "words": words, "pieces": pieces,
            "tok_to_orig": tok_to_orig}
    return f, meta


def best_span(start: torch.Tensor, end: torch.Tensor, max_ans_len: int):
    """(B,) best start + end over 0 <= end - start <= max_ans_len."""
    n = start.shape[1]
    i = torch.arange(n, device=start.device)
    band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :]
                                         <= max_ans_len)   # [end, start]
    s = start[:, None, :] + end[:, :, None]                # [b, end, start]
    s = torch.where(band[None], s, torch.tensor(float("-inf"),
                                                device=start.device))
    flat = s.reshape(s.shape[0], -1)
    best, pos = flat.max(1)
    return best, pos % n, pos // n


def answer_text(meta: Dict, start: int, end: int) -> str:
    """The answer of a span (positions in the whole input): "yes" / "no"
    at the context's first two words, else the original words the span's
    tokens come from, trimmed as MDR trims them."""
    s, e = start - meta["off"], end - meta["off"]
    if s == 0:
        return "yes"
    if s == 1:
        return "no"
    pieces = meta["pieces"]
    if s < 0 or s >= len(pieces):
        return ""
    e = min(max(e, s), len(pieces) - 1)
    orig = " ".join(meta["words"][meta["tok_to_orig"][s]:
                                  meta["tok_to_orig"][e] + 1])
    pred = " ".join(" ".join(pieces[s:e + 1]).replace(" ##", "")
                    .replace("##", "").strip().split())
    return _project(pred, orig).strip()


def _project(pred: str, orig: str) -> str:
    low = orig.lower()
    at = low.find(pred.lower())
    if at >= 0:
        return orig[at:at + len(pred)]
    ns_pred = pred.lower().replace(" ", "")
    keep = [i for i, c in enumerate(low) if c != " "]
    ns_orig = "".join(low[i] for i in keep)
    at = ns_orig.find(ns_pred)
    if at < 0:
        return orig
    return orig[keep[at]:keep[min(at + len(ns_pred) - 1, len(keep) - 1)] + 1]
