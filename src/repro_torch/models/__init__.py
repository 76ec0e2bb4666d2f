from repro_torch.models.cnn import MODELS, from_jax_params
from repro_torch.models.layers import cross_entropy
from repro_torch.models.model import LM, build_model, from_jax_lm_params

__all__ = ["MODELS", "from_jax_params", "cross_entropy", "LM", "build_model",
           "from_jax_lm_params"]
