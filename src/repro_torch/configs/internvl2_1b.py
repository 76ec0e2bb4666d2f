"""internvl2-1b [vlm] — InternViT frontend (stub) + qwen2-0.5b-like LM.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655  [arXiv:2404.16821; hf]
Vision stub: ``input_specs`` supplies 256 precomputed patch embeddings per
image (projected to d_model by a learned linear); the ViT itself is out of
scope per the assignment rules.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_655,
    n_img_tokens=256,
    vision_embed_dim=1024,       # InternViT-300M hidden size (stubbed output)
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="internvl2-1b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=173,
    n_img_tokens=8,
    vision_embed_dim=32,
    tie_embeddings=True,
)

register(FULL, SMOKE)
