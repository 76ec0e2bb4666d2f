"""Config system: ModelConfig (architecture), ShapeConfig (workload), registry.

A framework-free copy of the JAX package's ``configs/base.py`` (the port
imports nothing of that package), kept identical so ``get_config`` /
``smoke_config`` / ``list_configs`` name the same models in both.  Every
architecture has a module ``configs/<id>.py`` that registers a full-size
:class:`ModelConfig` and a ``smoke`` reduced config of the same family (used
by CPU tests).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "register", "get_config",
    "list_configs", "smoke_config",
]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- attention ---
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    window: Optional[int] = None     # sliding-window size (None = full attention)
    attn_softcap: Optional[float] = None

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_dispatch: str = "einsum"     # einsum | gather  (perf lever, see §Perf)

    # --- MLA (deepseek) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- hybrid (recurrentgemma / griffin) ---
    block_pattern: tuple = ()        # e.g. ("rec", "rec", "attn")
    rnn_width: int = 0

    # --- ssm (mamba2) ---
    ssm_state: int = 0
    ssm_chunk: int = 256
    d_inner: int = 0
    ssm_head_dim: int = 64
    conv_width: int = 4

    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0                 # precomputed frame-embedding length
    enc_causal: bool = False

    # --- vlm (internvl) ---
    n_img_tokens: int = 0
    vision_embed_dim: int = 0        # stub frontend output dim

    # --- numerics / misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"
    param_dtype: str = "bfloat16"
    dtype: str = "bfloat16"
    depth_scale_residual: bool = False   # minicpm
    scale_emb: float = 1.0
    logit_scale: float = 1.0
    remat: str = "full"              # full | dots | none
    max_seq: int = 8192
    # gradient-accumulation microbatches for the production train step
    # (activation memory scales ~1/M; grads accumulate in f32)
    train_microbatches: int = 1
    # attention score-tile sharding strategy: qrows | heads | repeat_kv
    # (see models/layers.chunked_attention)
    attn_score_shard: str = "qrows"
    # KV-cache storage dtype: bfloat16 | int8 (per-(pos, head) scales;
    # halves serving cache + its scan double-buffer — §Perf decode lever)
    kv_cache_dtype: str = "bfloat16"

    # Which workload shapes apply (see ShapeConfig); long_500k is skipped for
    # pure full-attention archs per the assignment rules.
    supports_long_context: bool = False
    is_encoder_only: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    # ---- derived ----
    @property
    def padded_vocab(self) -> int:
        """Embed/unembed tables padded to 256 (Megatron-style) so the vocab
        dim shards evenly on any mesh; padded logits are masked to -inf."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def scan_groups(self):
        """[(pattern tuple, n_repeats)] — homogeneous lax.scan groups."""
        if self.family == "hybrid" and self.block_pattern:
            p = len(self.block_pattern)
            reps, tail = divmod(self.n_layers, p)
            groups = []
            if reps:
                groups.append((tuple(self.block_pattern), reps))
            if tail:
                groups.append((tuple(self.block_pattern[:tail]), 1))
            return groups
        if self.family == "ssm":
            return [(("ssd",), self.n_layers)]
        if self.family == "moe":
            blk = "mla_moe" if self.use_mla else "attn_moe"
            return [((blk,), self.n_layers)]
        # dense / vlm-LM / encdec-decoder
        return [(("attn_mlp",), self.n_layers)]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (total; MoE counts all experts)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            din, ds = self.d_inner, self.ssm_state
            nh = din // self.ssm_head_dim
            per = (d * (2 * din + 2 * ds + nh)            # in_proj (x,z,B,C,dt)
                   + self.conv_width * (din + 2 * ds)     # conv over x,B,C
                   + din * d + 2 * nh + 2 * d)            # out_proj, A/D, norms
            return emb + self.n_layers * per
        # attention part
        if self.use_mla:
            r, dn, dr, dv = self.kv_lora_rank, self.qk_nope_dim, self.qk_rope_dim, self.v_head_dim
            attn = (d * self.n_heads * (dn + dr)           # q proj
                    + d * (r + dr)                        # kv down + rope k
                    + r * self.n_heads * (dn + dv)        # kv up
                    + self.n_heads * dv * d)              # out
        else:
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp_dense = 3 * d * f
        if self.family == "moe":
            n_e = self.n_experts + self.n_shared_experts
            per = attn + n_e * 3 * d * f + d * self.n_experts + 2 * d
            return emb + self.n_layers * per
        if self.family == "hybrid":
            w = self.rnn_width or d
            rec = d * w * 2 + self.conv_width * w + 3 * w + w * d   # proj, conv, gates, out
            n_attn = sum(1 for g, r in self.scan_groups() for b in g * r if b == "attn")
            n_rec = self.n_layers - n_attn
            return emb + n_attn * (attn + mlp_dense + 2 * d) + n_rec * (rec + mlp_dense + 2 * d)
        layers = self.n_layers * (attn + mlp_dense + 2 * d)
        if self.family == "encdec":
            enc_attn = 4 * d * d
            layers += self.n_enc_layers * (enc_attn + 2 * d * f + 2 * d)  # enc blocks (gelu mlp)
            layers += self.n_layers * attn                               # cross-attn per dec layer
        return emb + layers

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        total = self.param_count()
        all_experts = self.n_layers * self.n_experts * 3 * d * f
        active = self.n_layers * (self.top_k) * 3 * d * f
        return total - all_experts + active


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, ModelConfig] = {}
_SMOKE: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke
    return cfg


def _ensure_loaded():
    # import arch modules lazily to avoid import cycles
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        recurrentgemma_2b, deepseek_v2_lite_16b, mixtral_8x22b, whisper_tiny,
        minicpm_2b, granite_34b, qwen3_32b, phi4_mini_3_8b, internvl2_1b,
        mamba2_1_3b,
    )


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    return _REGISTRY[name]


def smoke_config(name: str) -> ModelConfig:
    _ensure_loaded()
    return _SMOKE[name]


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    out = ["train_4k", "prefill_32k"]
    if not cfg.is_encoder_only:
        out.append("decode_32k")
        if cfg.supports_long_context:
            out.append("long_500k")
    return out
