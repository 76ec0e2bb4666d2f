"""whisper-tiny [audio] — encoder-decoder backbone; conv frontend stubbed.

4L d_model=384 6H d_ff=1536 vocab=51865  [arXiv:2212.04356]
``input_specs`` supplies precomputed frame embeddings (1500, 384) — the
conv1d/log-mel frontend is a stub per the assignment rules.  The decoder
decodes, so decode_32k runs as a backbone stress shape (real whisper caps at
448 positions — noted in DESIGN.md).  Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,                   # decoder layers
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51_865,
    enc_seq=1500,
    act="gelu",
    rope_theta=10_000.0,          # backbone uses RoPE in lieu of learned abs-pos
)

SMOKE = ModelConfig(
    name="whisper-tiny-smoke",
    family="encdec",
    n_layers=2,
    n_enc_layers=2,
    d_model=48,
    n_heads=3,
    n_kv_heads=3,
    head_dim=16,
    d_ff=96,
    vocab_size=193,
    enc_seq=32,
    act="gelu",
)

register(FULL, SMOKE)
