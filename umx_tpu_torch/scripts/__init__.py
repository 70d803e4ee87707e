"""The port's counterparts of the repository's ``scripts/`` that drive
the JAX package, as modules: ``python -m umx_tpu_torch.scripts.<name>``."""
