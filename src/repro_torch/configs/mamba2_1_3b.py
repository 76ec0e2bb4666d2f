"""mamba2-1.3b [ssm] — state-space duality (SSD), attention-free.

48L d_model=2048 d_inner=4096 ssm_state=128 headdim=64 vocab=50280
[arXiv:2405.21060]   Decode state is O(1) in sequence length -> long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=50_280,
    d_inner=4096,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_chunk=128,
    conv_width=4,
    supports_long_context=True,
    tie_embeddings=True,
    train_microbatches=2,
)

SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=181,
    d_inner=128,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_chunk=16,
    conv_width=4,
    supports_long_context=True,
    tie_embeddings=True,
)

register(FULL, SMOKE)
