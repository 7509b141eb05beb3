"""Retrieval error taxonomy (mdr/retrieval/decomposed_analysis.py parity).

Buckets each failed question by WHERE the chain broke:

  * start_hop_error  — neither retrieved hop-1 candidate set nor final chains
                       contain the gold start passage
  * bridge_hop_error — the start passage was found but no chain completes
                       with the gold bridge passage
  * ordering_error   — both gold titles retrieved but never as one chain

A copy of the JAX package's ``eval/analysis.py`` (host only).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence


def decompose_errors(sp_titles: Sequence[str], qtype: str,
                     path_titles: List[List[str]],
                     hop1_titles: List[str],
                     bridge: str = None) -> Dict:
    """`bridge` (the second-hop gold title, available in HotpotQA bridge
    rows) disambiguates WHICH gold title had to come first — without it,
    a question whose hop-1 set contains only the bridge passage would be
    misread as "start found" (the reference keys its buckets off
    item['bridge'], decomposed_analysis.py:23-33)."""
    gold = set(sp_titles)
    retrieved = set(t for pair in path_titles for t in pair)
    hop1 = set(hop1_titles)
    path_hit = any(set(p) == gold for p in path_titles)
    row = {"type": qtype, "correct": int(path_hit),
           "start_hop_error": 0, "bridge_hop_error": 0, "ordering_error": 0}
    if path_hit:
        return row
    if bridge is not None and bridge in gold and len(gold) == 2:
        start_title = next(t for t in gold if t != bridge)
        start_found = start_title in hop1 or start_title in retrieved
    else:
        # no bridge label (comparison questions / missing metadata): any
        # gold title in hop-1 counts as a found start
        start_found = bool(gold & hop1)
    if not start_found:
        row["start_hop_error"] = 1
    elif gold <= retrieved:
        row["ordering_error"] = 1
    else:
        row["bridge_hop_error"] = 1
    return row


def aggregate_errors(rows: List[Dict]) -> Dict:
    def agg(items):
        n = len(items)
        keys = ["correct", "start_hop_error", "bridge_hop_error",
                "ordering_error"]
        return {"n": n,
                **{k: (sum(r[k] for r in items) / n if n else 0.0)
                   for k in keys}}

    out = {"overall": agg(rows)}
    by_type = collections.defaultdict(list)
    for r in rows:
        by_type[r["type"]].append(r)
    for t, items in by_type.items():
        out[t] = agg(items)
    return out
