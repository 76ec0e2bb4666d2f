from repro_torch.models.cnn import MODELS, from_jax_params
from repro_torch.models.layers import cross_entropy

__all__ = ["MODELS", "from_jax_params", "cross_entropy"]
