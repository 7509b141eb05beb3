"""Variable-hop (unified) datasets with stop targets + FEVER variants (a
numpy-only copy of the JAX package's ``data/unified_dataset.py``).

Re-design of mdr/retrieval/data/unified_dataset.py and fever_dataset.py:

  * `UnifiedDataset`   — mixed single/bridge/comparison rows; `stop` target
                         is 1 for multi-hop samples, 0 for single-hop
                         (unified_dataset.py:47-93); single-hop rows use a
                         random negative (or dummy) as the unused c2; NQ
                         passages get a trailing period stripped
                         (unified_dataset.py:36-39)
  * `FeverDataset`     — multi-hop FEVER claims: first multi-title evidence
                         chain as (c1, c2); negatives = tfidf + linked
                         (fever_dataset.py:55-70)
  * `FeverSampler`     — rebalances single- vs multi-evidence claims at
                         `ratio` singles per multi (unified_dataset.py:186-206)
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from .corpus import nfd_normalize as _normalize
from .tokenization import _Base as Tokenizer

DUMMY = {"title": "dummy", "text": "dummy"}


class UnifiedDataset:
    def __init__(self, tokenizer: Tokenizer, data_path: str,
                 max_q_len: int = 70, max_q_sp_len: int = 350,
                 max_c_len: int = 300, train: bool = False, seed: int = 3):
        self.tok = tokenizer
        self.max_q_len = max_q_len
        self.max_q_sp_len = max_q_sp_len
        self.max_c_len = max_c_len
        self.train = train
        self.rng = np.random.RandomState(seed)
        with open(data_path) as f:
            self.data = [json.loads(l) for l in f if l.strip()]
        if train:
            self.data = [r for r in self.data if len(r.get("neg_paras", [])) >= 2]

    def __len__(self):
        return len(self.data)

    def _encode_para(self, para, max_len):
        text = para["text"].strip()
        if text.endswith("."):
            text = text[:-1]  # NQ passages don't end with periods
        return self.tok.encode_pair(para["title"].strip(), text, max_len)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.getitem_rng(index, self.rng)

    def getitem_rng(self, index: int, rng) -> Dict[str, np.ndarray]:
        """Per-call RNG variant (BatchLoader derives one stream per sample
        so pool workers never race the shared `self.rng`)."""
        sample = self.data[index]
        question = sample["question"]
        if question.endswith("?"):
            question = question[:-1]
        mhop = True
        pos = list(sample["pos_paras"])
        negs = list(sample.get("neg_paras", []))
        if sample["type"] == "comparison":
            if self.train:
                rng.shuffle(pos)
            start_para, bridge_para = pos
        elif sample["type"] == "bridge":
            start_para = bridge_para = None
            for para in pos:
                if para["title"] != sample["bridge"]:
                    start_para = para
                else:
                    bridge_para = para
        elif sample["type"] == "single":
            mhop = False
            start_para = pos[0]
            bridge_para = (negs[rng.randint(len(negs))]
                           if negs else dict(DUMMY))
        else:
            raise ValueError(f"unknown type {sample['type']}")

        if self.train:
            rng.shuffle(negs)
        neg1 = negs[0] if negs else dict(DUMMY)
        neg2 = negs[1] if len(negs) > 1 else dict(DUMMY)

        q = self.tok.encode_one(question, self.max_q_len)
        q_sp = self.tok.encode_pair(question, start_para["text"].strip(),
                                    self.max_q_sp_len)
        out = {
            "q_input_ids": q["input_ids"], "q_mask": q["attention_mask"],
            "q_sp_input_ids": q_sp["input_ids"],
            "q_sp_mask": q_sp["attention_mask"],
            "stop_targets": np.int32(int(mhop)),
        }
        # BERT-style tokenizers: q_sp is a PAIR encoding whose segment-B ids
        # must reach the encoder (unified_collate emits q_type_ids /
        # q_sp_type_ids, unified_dataset.py:235-244) — dropping them would
        # embed the passage half with segment-0 while c1/c2/negs in the
        # same batch get correct segment-1 ids
        if "token_type_ids" in q:
            out["q_type_ids"] = q["token_type_ids"]
        if "token_type_ids" in q_sp:
            out["q_sp_type_ids"] = q_sp["token_type_ids"]
        for name, para in (("c1", start_para), ("c2", bridge_para),
                           ("neg1", neg1), ("neg2", neg2)):
            enc = self._encode_para(para, self.max_c_len)
            out[f"{name}_input_ids"] = enc["input_ids"]
            out[f"{name}_mask"] = enc["attention_mask"]
            if "token_type_ids" in enc:
                out[f"{name}_type_ids"] = enc["token_type_ids"]
        return out


class FeverDataset:
    """Multi-hop FEVER claims (fever_dataset.py:28-84)."""

    def __init__(self, tokenizer: Tokenizer, data_path: str,
                 max_q_len: int = 70, max_q_sp_len: int = 350,
                 max_c_len: int = 300, train: bool = False, seed: int = 3):
        self.tok = tokenizer
        self.max_q_len = max_q_len
        self.max_q_sp_len = max_q_sp_len
        self.max_c_len = max_c_len
        self.train = train
        self.rng = np.random.RandomState(seed)
        with open(data_path) as f:
            self.data = [json.loads(l) for l in f if l.strip()]
        # keep only claims with at least one multi-title evidence chain and
        # >=2 negatives (the reference would crash otherwise)
        self.data = [r for r in self.data
                     if any(len({p["title"] for p in e}) > 1
                            for e in r["evidence"])
                     and len(r.get("tfidf_neg", []))
                     + len(r.get("linked_neg", [])) >= 2]

    def __len__(self):
        return len(self.data)

    def _encode_para(self, para, max_len):
        return self.tok.encode_pair(_normalize(para["title"].strip()),
                                    para["text"].strip(), max_len)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.getitem_rng(index, self.rng)

    def getitem_rng(self, index: int, rng) -> Dict[str, np.ndarray]:
        sample = self.data[index]
        question = sample["claim"]
        evidence_multi = [e for e in sample["evidence"]
                          if len({p["title"] for p in e}) > 1]
        negs = list(sample.get("tfidf_neg", [])) + \
            list(sample.get("linked_neg", []))
        if self.train:
            rng.shuffle(evidence_multi)
            rng.shuffle(negs)
        start_para, bridge_para = evidence_multi[0][0], evidence_multi[0][1]

        q = self.tok.encode_one(question, self.max_q_len)
        q_sp = self.tok.encode_pair(question, start_para["text"].strip(),
                                    self.max_q_sp_len)
        out = {
            "q_input_ids": q["input_ids"], "q_mask": q["attention_mask"],
            "q_sp_input_ids": q_sp["input_ids"],
            "q_sp_mask": q_sp["attention_mask"],
        }
        if "token_type_ids" in q:
            out["q_type_ids"] = q["token_type_ids"]
        if "token_type_ids" in q_sp:
            out["q_sp_type_ids"] = q_sp["token_type_ids"]
        for name, para in (("c1", start_para), ("c2", bridge_para),
                           ("neg1", negs[0]), ("neg2", negs[1])):
            enc = self._encode_para(para, self.max_c_len)
            out[f"{name}_input_ids"] = enc["input_ids"]
            out[f"{name}_mask"] = enc["attention_mask"]
            if "token_type_ids" in enc:
                out[f"{name}_type_ids"] = enc["token_type_ids"]
        return out


class FeverSampler:
    """Rebalance single- vs multi-evidence claims (unified_dataset.py:186-206).

    Expects the dataset to expose `single_ids` / `multi_ids` index lists;
    yields all multis plus ratio× as many singles, shuffled.
    """

    def __init__(self, single_ids: List[int], multi_ids: List[int],
                 ratio: int = 1, seed: int = 0):
        self.single_ids = list(single_ids)
        self.multi_ids = list(multi_ids)
        self.ratio = ratio
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        # must agree with epoch_indices(): the singles pool can run short
        # of multi_ids * ratio
        return len(self.multi_ids) + min(len(self.single_ids),
                                         len(self.multi_ids) * self.ratio)

    def epoch_indices(self) -> List[int]:
        singles = list(self.single_ids)
        self.rng.shuffle(singles)
        out = self.multi_ids + singles[: len(self.multi_ids) * self.ratio]
        self.rng.shuffle(out)
        return out
