"""Twins of the JAX package's ``examples/``: each runs with ``python -m
repro_torch.examples.<name>`` on the CUDA card, or with ``--device cpu`` on
the plain versions, and its ``main`` takes the sizes and step counts as
arguments (the JAX example's values by default) and returns what its check
reads."""
