from .mips import (LAUNCHES, NEG_INF, build_pca_prefilter, merge_multivector,
                   mips_scan, mips_scan_int8, mips_topk, mips_topk_pca,
                   pca_chunk_max, pca_rescan_int8, quantize_rows,
                   reset_launch_counts, topk_lower_index, train_pca_rotation)

__all__ = ["LAUNCHES", "NEG_INF", "build_pca_prefilter", "merge_multivector",
           "mips_scan", "mips_scan_int8", "mips_topk", "mips_topk_pca",
           "pca_chunk_max", "pca_rescan_int8", "quantize_rows",
           "reset_launch_counts", "topk_lower_index", "train_pca_rotation"]
