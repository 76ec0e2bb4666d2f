"""granite-34b [dense] — deep llama-arch code model with MQA.

88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152  [arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24_576,
    vocab_size=49_152,
    act="gelu_tanh",
    train_microbatches=4,
    attn_score_shard="heads",      # MQA G=48 divides tp=16 — §Perf iteration 1
)

SMOKE = ModelConfig(
    name="granite-34b-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=192,
    vocab_size=199,
    act="gelu_tanh",
)

register(FULL, SMOKE)
