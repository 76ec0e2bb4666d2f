"""phi4-mini-3.8b [dense] — RoPE + SwiGLU + GQA.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064  [arXiv:2412.08905; hf]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200_064,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="phi4-mini-3.8b-smoke",
    family="dense",
    n_layers=2,
    d_model=48,
    n_heads=6,
    n_kv_heads=2,
    head_dim=8,
    d_ff=128,
    vocab_size=227,
    tie_embeddings=True,
)

register(FULL, SMOKE)
