from .fused_attention import fused_attention, fused_attention_plain
from .mips import (LAUNCHES, NEG_INF, auto_chunk_rows, build_pca_prefilter,
                   chunk_max, chunk_max_int8, merge_multivector, mips_scan,
                   mips_scan_int8, mips_topk, mips_topk_pca,
                   mips_topk_two_phase, pca_chunk_max, pca_rescan_int8,
                   quantize_rows, rescan, reset_launch_counts,
                   sharded_mips_topk, sharded_mips_topk_pca,
                   topk_lower_index, train_pca_rotation, two_phase_chunk)

__all__ = ["LAUNCHES", "NEG_INF", "auto_chunk_rows", "build_pca_prefilter",
           "chunk_max", "chunk_max_int8", "fused_attention",
           "fused_attention_plain", "merge_multivector", "mips_scan",
           "mips_scan_int8", "mips_topk", "mips_topk_pca",
           "mips_topk_two_phase", "pca_chunk_max", "pca_rescan_int8",
           "quantize_rows", "rescan", "reset_launch_counts",
           "sharded_mips_topk", "sharded_mips_topk_pca", "topk_lower_index",
           "train_pca_rotation", "two_phase_chunk"]
