from .beam import BeamSearcher, assemble_pair_inputs, truncate_longest_first

__all__ = ["BeamSearcher", "assemble_pair_inputs", "truncate_longest_first"]
