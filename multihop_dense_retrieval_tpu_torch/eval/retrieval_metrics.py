"""Retrieval metrics: PR / P-EM / 1-Recall / Path Recall, overall and by type.

Host-side re-implementation of the metric block in
scripts/eval/eval_mhop_retrieval.py:219-242,265-284:

  * p_recall  — any gold SP title appears among retrieved titles (both hops)
  * p_em      — both gold SP titles appear
  * recall_1  — any gold SP title among hop-1 titles
  * path_covered — some top-k chain's {title pair} equals the gold SP set
"""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence


def chain_metrics(sp_titles: Sequence[str], qtype: str,
                  path_titles: List[List[str]],
                  hop1_titles: List[str]) -> Dict:
    """Metrics for one question given its ranked chains' titles.

    Gold SP titles are validated like the reference's
    `assert len(set(sp)) == 2` (eval_mhop_retrieval.py:222): an EMPTY sp
    list would score p_em=1 with p_recall=0 (vacuous all([])), silently
    inflating P-EM.  Hotpot types require exactly 2 distinct titles;
    single-hop rows (the --unified serving extension) may carry 1."""
    distinct = len(set(sp_titles))
    if distinct == 0 or (qtype in ("bridge", "comparison")
                         and distinct != 2):
        raise ValueError(
            f"bad gold SP titles {list(sp_titles)} for type={qtype!r} — "
            "malformed qas row?")
    retrieved = [t for pair in path_titles for t in pair]
    sp_covered = [t in retrieved for t in sp_titles]
    covered_1 = [t in hop1_titles for t in sp_titles]
    path_covered = any(set(p) == set(sp_titles) for p in path_titles)
    return {
        "p_recall": int(any(sp_covered)),
        "p_em": int(all(sp_covered)),
        "recall_1": int(any(covered_1)),
        "path_covered": int(path_covered),
        "type": qtype,
    }


def aggregate_metrics(metrics: List[Dict]) -> Dict[str, Dict[str, float]]:
    """Overall + per-type averages, mirroring the reference's log block."""
    def avg(items):
        n = len(items)
        return {
            "n": n,
            "avg_pr": sum(m["p_recall"] for m in items) / n,
            "avg_p_em": sum(m["p_em"] for m in items) / n,
            "avg_1_recall": sum(m["recall_1"] for m in items) / n,
            "path_recall": sum(m["path_covered"] for m in items) / n,
        }

    out = {"overall": avg(metrics)}
    by_type = collections.defaultdict(list)
    for m in metrics:
        by_type[m["type"]].append(m)
    for t, items in by_type.items():
        out[t] = avg(items)
    return out
