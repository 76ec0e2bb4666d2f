"""minicpm-2b [dense] — llama-like with WSD schedule + depth-scaled residuals.

40L d_model=2304 36H d_ff=5760 vocab=122753  [arXiv:2404.06395; hf]
The WSD (warmup-stable-decay) schedule is implemented in optim/schedules.py
and selected by this config's training recipe.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122_753,
    tie_embeddings=True,
    depth_scale_residual=True,
    scale_emb=12.0,
    logit_scale=1.0 / 9.0,        # d_model / dim_model_base(256) divisor
    kv_cache_dtype="int8",        # §Perf: full-MHA 32k cache busts 16G in bf16
)

SMOKE = ModelConfig(
    name="minicpm-2b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=160,
    vocab_size=241,
    tie_embeddings=True,
    depth_scale_residual=True,
    scale_emb=4.0,
    logit_scale=0.25,
)

register(FULL, SMOKE)
