"""qwen3-32b [dense] — GQA with per-head qk-norm.

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936  [hf:Qwen/Qwen3; hf]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25_600,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    train_microbatches=2,
    attn_score_shard="repeat_kv",  # H=64 divides tp — §Perf iteration 1
    kv_cache_dtype="int8",         # §Perf 5.2: 32k GQA cache 15.2G -> headroom
)

SMOKE = ModelConfig(
    name="qwen3-32b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab_size=251,
    qk_norm=True,
)

register(FULL, SMOKE)
