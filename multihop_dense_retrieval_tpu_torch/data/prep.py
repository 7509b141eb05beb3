"""Data-preparation utilities for HotpotQA-style corpora.

Re-design of mdr/retrieval/utils/mhop_utils.py (minus the FAIR-cluster
hard-coded paths): bridge-hop ordering, raw-HotpotQA → training rows, and
sentence-level SP annotation of retrieved chains for reader training.

A copy of the JAX package's ``data/prep.py`` (host only).
"""

from __future__ import annotations

import collections
import json
from typing import Dict, List, Optional, Sequence


def pick_bridge(title2linked: Dict[str, Sequence[str]],
                title2doc: Dict[str, str], titles: Sequence[str],
                answer: str) -> str:
    """Which of the two SP titles is the SECOND (bridge) hop
    (mhop_utils.py:16-29): prefer the passage containing the answer
    (assuming only hop-2 does); fall back to the hyperlink direction
    (if A links to B, B is second); default to titles[1]."""
    t0, t1 = titles[0], titles[1]
    in0 = answer in t0 + " " + title2doc.get(t0, "")
    in1 = answer in t1 + " " + title2doc.get(t1, "")
    if in0 and not in1:
        return t0
    if in1 and not in0:
        return t1
    linked1 = title2linked.get(t1, [])
    linked0 = title2linked.get(t0, [])
    if t0 in linked1 and t1 not in linked0:
        return t0
    return t1


def hotpot_to_mhop_rows(raw_items: List[Dict],
                        title2linked: Optional[Dict] = None) -> List[Dict]:
    """Raw HotpotQA json → multi-hop training/eval rows (hotpot_sp_data).

    Output rows carry question/type/pos_paras/bridge/sp/answer; negatives
    (tfidf/linked) must be attached by a separate mining step.
    """
    rows = []
    for item in raw_items:
        title2passage = {c[0]: "".join(c[1]) for c in item["context"]}
        sp_titles = list(dict.fromkeys(t for t, _ in item["supporting_facts"]))
        pos_paras = [{"title": t, "text": title2passage.get(t, "")}
                     for t in sp_titles]
        row = {
            "question": item["question"],
            "_id": item.get("_id"),
            "type": item["type"],
            "pos_paras": pos_paras,
            "neg_paras": item.get("neg_paras", []),
            "sp": sp_titles,
            "answer": [item["answer"]] if isinstance(item.get("answer"), str)
            else item.get("answer", []),
        }
        if item["type"] == "bridge" and len(sp_titles) == 2:
            row["bridge"] = pick_bridge(title2linked or {}, title2passage,
                                        sp_titles, row["answer"][0]
                                        if row["answer"] else "")
        rows.append(row)
    return rows


def add_sp_labels(raw_items: List[Dict], retrieved: List[Dict],
                  title2sents: Dict[str, List[str]]) -> List[Dict]:
    """Attach sentence-level SP supervision to retrieved chains for reader
    training (mhop_utils.py:173-210): each gold title gets its sentence list
    and the indices of its supporting sentences."""
    out = []
    for instance, raw in zip(retrieved, raw_items):
        assert instance["question"] == raw["question"], "row order mismatch"
        inst = dict(instance)
        if "supporting_facts" in raw:
            sp_map = collections.defaultdict(list)
            for title, sent_id in raw["supporting_facts"]:
                sp_map[title].append(sent_id)
            absent = [t for t in sp_map if t not in title2sents]
            if absent:
                raise ValueError(
                    f"gold SP title(s) {absent} not in title2sents for "
                    f"question {raw['question']!r} — fullwiki-style raw "
                    "files hold retrieved (not gold) context; build the "
                    "sentence map from a corpus that covers every gold "
                    "paragraph (the reference used the full abstracts "
                    "dump, mhop_utils.py add_sp_labels)")
            inst["sp"] = [{"title": t, "sents": title2sents[t],
                           "sp_sent_ids": ids} for t, ids in sp_map.items()]
            inst["answer"] = [raw["answer"]] if isinstance(raw["answer"], str) \
                else raw["answer"]
            inst["type"] = raw.get("type", inst.get("type"))
        out.append(inst)
    return out


def gen_index_id_map(id2doc_path: str, save_path: str):
    """Row index → doc id JSON map (utils/gen_index_id_map.py:6-14)."""
    with open(id2doc_path) as f:
        id2doc = json.load(f)
    with open(save_path, "w") as f:
        json.dump({str(i): k for i, k in enumerate(id2doc)}, f)
