"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + 64 routed top-6 + 2 shared.

27L d_model=2048 16H d_ff=1408(expert) vocab=102400  [arXiv:2405.04434; hf]
The assignment note "2 shared+160 routed" matches full DeepSeek-V2; the Lite
config (hf: deepseek-ai/DeepSeek-V2-Lite) is 64 routed + 2 shared, top-6 —
we follow the Lite numbers stated on the assignment line ("MoE 64e top-6").
Full attention (MLA compresses KV but attention is still quadratic) ->
long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,                # qk_nope 128 + qk_rope 64
    d_ff=1408,
    vocab_size=102_400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    capacity_factor=1.25,
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
    train_microbatches=2,
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-16b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=24,                 # nope 16 + rope 8
    d_ff=48,
    vocab_size=211,
    n_experts=8,
    n_shared_experts=2,
    top_k=2,
    capacity_factor=1.5,
    use_mla=True,
    kv_lora_rank=32,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
)

register(FULL, SMOKE)
