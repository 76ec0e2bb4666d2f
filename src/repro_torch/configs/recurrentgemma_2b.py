"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, Griffin 1:2 pattern.

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000  [arXiv:2402.19427; hf]
Pattern: (rec, rec, local-attn) repeated; local attention window 2048.
Sub-quadratic (recurrence + bounded window) -> long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=("rec", "rec", "attn"),
    rnn_width=2560,
    conv_width=4,
    window=2048,
    act="gelu_tanh",
    tie_embeddings=True,
    scale_emb=2560 ** 0.5,
    supports_long_context=True,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke",
    family="hybrid",
    n_layers=4,                      # (rec, rec, attn) + 1 rec tail
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=257,
    block_pattern=("rec", "rec", "attn"),
    rnn_width=64,
    conv_width=4,
    window=16,
    act="gelu_tanh",
    tie_embeddings=True,
    scale_emb=8.0,
    supports_long_context=True,
)

register(FULL, SMOKE)
