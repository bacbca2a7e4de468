"""The port's copy of the JAX package's data pipeline."""
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: F401
