"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768  [arXiv:2401.04088; hf]
SWA window per assignment line -> sub-quadratic -> long_500k runs (windowed
KV cache of 4096).
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32_768,
    n_experts=8,
    n_shared_experts=0,
    top_k=2,
    capacity_factor=1.25,
    window=4096,
    rope_theta=1_000_000.0,
    supports_long_context=True,
    train_microbatches=8,   # §Perf iter 3: M=4 cuts collectives 17% but busts the 16G budget (16.02G) — kept at 8
    attn_score_shard="repeat_kv",  # H=48 divides tp — §Perf iteration 1
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=223,
    n_experts=4,
    n_shared_experts=0,
    top_k=2,
    capacity_factor=1.5,
    window=16,
    supports_long_context=True,
)

register(FULL, SMOKE)
