"""HotpotQA multi-hop training/eval dataset (a numpy-only copy of the JAX
package's ``data/mhop_dataset.py``: the same rows give the same arrays).

Re-design of mdr/retrieval/data/mhop_dataset.py:12-121 emitting fixed-shape
numpy batches.  Row format (JSONL):

  {"question": ..., "type": "bridge"|"comparison",
   "pos_paras": [{"title","text"}, {"title","text"}],
   "neg_paras": [...], "bridge": <title of the 2nd-hop para>, ...}

Semantics preserved from the reference:
  * trailing '?' stripped from the question (mhop_dataset.py:48-49)
  * comparison questions: the two positives are order-shuffled in training
    (mhop_dataset.py:50-52); bridge questions: the para whose title equals
    `bridge` is hop-2 (mhop_dataset.py:53-58)
  * negatives shuffled in training, first two used (mhop_dataset.py:59-65)
  * q⊕sp view pairs the question with the *start* para text (mhop_dataset.py:67)
  * rows with <2 negatives dropped in training (mhop_dataset.py:39)

NOT replicated (reference defects, SURVEY.md §7): the pdb breakpoint and the
`tfidf_neg` override at mhop_dataset.py:32-36.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from .tokenization import _Base as Tokenizer


class MhopDataset:
    def __init__(self, tokenizer: Tokenizer, data_path: str,
                 max_q_len: int = 70, max_q_sp_len: int = 350,
                 max_c_len: int = 300, train: bool = False,
                 seed: int = 3):
        self.tok = tokenizer
        self.max_q_len = max_q_len
        self.max_q_sp_len = max_q_sp_len
        self.max_c_len = max_c_len
        self.train = train
        self.rng = np.random.RandomState(seed)
        with open(data_path) as f:
            self.data = [json.loads(line) for line in f if line.strip()]
        if train:
            self.data = [r for r in self.data if len(r.get("neg_paras", [])) >= 2]

    def __len__(self):
        return len(self.data)

    def _encode_para(self, para, max_len):
        return self.tok.encode_pair(para["title"].strip(), para["text"].strip(),
                                    max_len)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.getitem_rng(index, self.rng)

    def getitem_rng(self, index: int, rng) -> Dict[str, np.ndarray]:
        """Per-call RNG variant (BatchLoader passes a sample-derived stream
        so pool workers never race the shared `self.rng`)."""
        sample = self.data[index]
        question = sample["question"]
        if question.endswith("?"):
            question = question[:-1]
        pos = list(sample["pos_paras"])
        if sample["type"] == "comparison":
            if self.train:
                rng.shuffle(pos)
            start_para, bridge_para = pos
        else:
            start_para = bridge_para = None
            for para in pos:
                if para["title"] != sample["bridge"]:
                    start_para = para
                else:
                    bridge_para = para
        negs = list(sample["neg_paras"])
        if self.train:
            rng.shuffle(negs)

        q = self.tok.encode_one(question, self.max_q_len)
        q_sp = self.tok.encode_pair(question, start_para["text"].strip(),
                                    self.max_q_sp_len)
        out = {
            "q_input_ids": q["input_ids"], "q_mask": q["attention_mask"],
            "q_sp_input_ids": q_sp["input_ids"], "q_sp_mask": q_sp["attention_mask"],
        }
        for name, para in (("c1", start_para), ("c2", bridge_para),
                           ("neg1", negs[0]), ("neg2", negs[1])):
            enc = self._encode_para(para, self.max_c_len)
            out[f"{name}_input_ids"] = enc["input_ids"]
            out[f"{name}_mask"] = enc["attention_mask"]
            if "token_type_ids" in enc:
                out[f"{name}_type_ids"] = enc["token_type_ids"]
        for k, enc in (("q", q), ("q_sp", q_sp)):
            if "token_type_ids" in enc:
                out[f"{k}_type_ids"] = enc["token_type_ids"]
        return out


def mhop_collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack fixed-shape per-sample dicts into a batch (reference pads here,
    mhop_dataset.py:82-121; we already emitted static shapes)."""
    if not samples:
        return {}
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
