"""Reader steps (the inference half of the JAX package's ``train/``)."""
