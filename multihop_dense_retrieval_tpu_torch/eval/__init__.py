from .hotpot_metrics import (exact_match_score, f1_score, normalize_answer,
                             update_answer, update_sp)
from .retrieval_metrics import aggregate_metrics, chain_metrics

__all__ = ["aggregate_metrics", "chain_metrics", "exact_match_score",
           "f1_score", "normalize_answer", "update_answer", "update_sp"]
