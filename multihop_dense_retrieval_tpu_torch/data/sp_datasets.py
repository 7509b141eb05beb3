"""Single-hop (DPR-style) datasets: NQ/WebQ/TriviaQA + FEVER single-evidence
(a numpy-only copy of the JAX package's ``data/sp_datasets.py``: the same
rows and seed give the same arrays).

Re-design of mdr/retrieval/data/sp_datasets.py: rows carry a question (or
FEVER claim), `pos_paras`/`pos_para` and `neg_paras`; training samples a
random positive and shuffles negatives; empty negative lists fall back to a
random other sample's positive (train) or a dummy (eval)
(sp_datasets.py:41-68).
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np

from .corpus import nfd_normalize as _normalize
from .tokenization import _Base as Tokenizer


class SPDataset:
    def __init__(self, tokenizer: Tokenizer, data_path: str,
                 max_q_len: int = 50, max_c_len: int = 300,
                 train: bool = False, seed: int = 3, fever: bool = False):
        self.tok = tokenizer
        self.max_q_len = max_q_len
        self.max_c_len = max_c_len
        self.train = train
        self.fever = fever
        self.rng = np.random.RandomState(seed)
        with open(data_path) as f:
            self.data = [json.loads(l) for l in f if l.strip()]

    def __len__(self):
        return len(self.data)

    def _row_pos_neg(self, sample):
        if self.fever:
            # FEVER single-evidence claims (sp_datasets.py FeverSingleDataset):
            # positives are all single-evidence pages; negatives tfidf+linked
            question = sample["claim"]
            pos_paras, seen = [], set()
            for e in sample["evidence"]:
                group = e if isinstance(e, list) else [e]
                for p in group:
                    if p["title"] not in seen:
                        seen.add(p["title"])
                        pos_paras.append(p)
            neg_paras = list(sample.get("tfidf_neg", [])) + \
                list(sample.get("linked_neg", []))
        else:
            question = sample["question"]
            if question.endswith("?"):
                question = question[:-1]
            pos = sample.get("pos_paras", sample.get("pos_para"))
            pos_paras = pos if isinstance(pos, list) else [pos]
            neg_paras = list(sample.get("neg_paras", []))
        return question, pos_paras, neg_paras

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.getitem_rng(index, self.rng)

    def getitem_rng(self, index: int, rng) -> Dict[str, np.ndarray]:
        """Per-call RNG variant (BatchLoader derives one stream per sample
        so pool workers never race the shared `self.rng`)."""
        sample = self.data[index]
        question, pos_paras, neg_paras = self._row_pos_neg(sample)
        if self.train:
            pos = pos_paras[rng.randint(len(pos_paras))]
            rng.shuffle(neg_paras)
        else:
            pos = pos_paras[0]
        if neg_paras:
            neg = neg_paras[0]
        elif self.train:
            other = self.data[rng.randint(len(self.data))]
            _, other_pos, _ = self._row_pos_neg(other)
            neg = other_pos[0]
        else:
            neg = {"title": "dummy", "text": "dummy"}

        q = self.tok.encode_one(question, self.max_q_len)
        out = {"q_input_ids": q["input_ids"], "q_mask": q["attention_mask"]}
        for name, para in (("c", pos), ("neg", neg)):
            enc = self.tok.encode_pair(_normalize(para["title"].strip()),
                                       para["text"].strip(), self.max_c_len)
            out[f"{name}_input_ids"] = enc["input_ids"]
            out[f"{name}_mask"] = enc["attention_mask"]
            if "token_type_ids" in enc:
                out[f"{name}_type_ids"] = enc["token_type_ids"]
        if "token_type_ids" in q:
            out["q_type_ids"] = q["token_type_ids"]
        return out


class NQMhopDataset:
    """NQ error-recovery rows (sp_datasets.py NQMhopDataset): the model must
    recover from a wrong first retrieval — `q_neg1` = question ⊕ top wrong
    passage; plain `q` is [MASK]-augmented to fixed length.  Rows:
    {"question", "pos_paras", "top_neg"}; rows with <2 top_neg dropped."""

    def __init__(self, tokenizer: Tokenizer, data_path: str,
                 max_q_len: int = 50, max_q_sp_len: int = 350,
                 max_c_len: int = 300, train: bool = False, seed: int = 3,
                 augment: bool = True):
        self.tok = tokenizer
        self.max_q_len = max_q_len
        self.max_q_sp_len = max_q_sp_len
        self.max_c_len = max_c_len
        self.train = train
        self.augment = augment
        self.rng = np.random.RandomState(seed)
        with open(data_path) as f:
            self.data = [json.loads(l) for l in f if l.strip()]
        self.data = [r for r in self.data if len(r.get("top_neg", [])) >= 2]

    def __len__(self):
        return len(self.data)

    def _para(self, para, max_len):
        text = para["text"].strip() or para["title"].strip()
        return self.tok.encode_pair(para["title"].strip(), text, max_len)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.getitem_rng(index, self.rng)

    def getitem_rng(self, index: int, rng) -> Dict[str, np.ndarray]:
        sample = self.data[index]
        question = sample["question"]
        negs = list(sample["top_neg"])
        if self.train:
            rng.shuffle(negs)
        error_para, neg_para = negs[0], negs[1]
        pos_para = sample["pos_paras"][0]

        if self.augment:
            q = self.tok.encode_one_augmented(question, self.max_q_len)
        else:
            q = self.tok.encode_one(question, self.max_q_len)
        err_text = error_para["text"].strip() or error_para["title"].strip()
        q_neg1 = self.tok.encode_pair(question, err_text, self.max_q_sp_len)

        out = {"q_input_ids": q["input_ids"], "q_mask": q["attention_mask"],
               "q_neg1_input_ids": q_neg1["input_ids"],
               "q_neg1_mask": q_neg1["attention_mask"]}
        for name, para in (("c", pos_para), ("neg", neg_para)):
            enc = self._para(para, self.max_c_len)
            out[f"{name}_input_ids"] = enc["input_ids"]
            out[f"{name}_mask"] = enc["attention_mask"]
            if "token_type_ids" in enc:
                out[f"{name}_type_ids"] = enc["token_type_ids"]
        return out


# identical stacking semantics — one definition (mhop_dataset.py)
from .mhop_dataset import mhop_collate as sp_collate  # noqa: E402
