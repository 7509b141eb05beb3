from .config import (EncoderConfig, RetrieverTrainConfig, SearchConfig,
                     default_hop2_tiling,
                     HOP2_BUCKETS_5TILE, HOP2_TILE_FRACS_5TILE,
                     HOP2_BUCKETS_6TILE, HOP2_TILE_FRACS_6TILE)
from .device import resolve_device

__all__ = ["EncoderConfig", "RetrieverTrainConfig", "SearchConfig",
           "default_hop2_tiling",
           "HOP2_BUCKETS_5TILE", "HOP2_TILE_FRACS_5TILE",
           "HOP2_BUCKETS_6TILE", "HOP2_TILE_FRACS_6TILE", "resolve_device"]
