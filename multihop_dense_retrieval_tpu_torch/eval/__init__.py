from .retrieval_metrics import aggregate_metrics, chain_metrics

__all__ = ["aggregate_metrics", "chain_metrics"]
