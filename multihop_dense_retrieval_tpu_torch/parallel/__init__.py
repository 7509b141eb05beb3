from .sharding import constrain_params, encoder_param_specs, shard_params

__all__ = ["encoder_param_specs", "constrain_params", "shard_params"]
