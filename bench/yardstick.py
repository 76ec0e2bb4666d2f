"""The benchmark's yardstick: the card's peaks, each kernel's operations and
bytes, and the model FLOPs behind ``round_mfu``.

Frozen copies, so that a change to the program cannot move the ruler it is
measured with: the peaks are those of ``repro_torch/kernels/_common.py``
(NVIDIA's H100 SXM data sheet, dense rates at 700 W), and the kernels'
operations and bytes are the formulas of ``chip_smoke.py``'s timing phases.
``bench/test_bench_yardstick.py`` checks that the copies still equal the
originals and the FLOP count against the program's own op counter.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12           # HBM3 bandwidth
F32_FLOPS_PER_S = 67e12             # f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12           # bf16 on the tensor cores
F32_TC_FLOPS_PER_S = 495e12 / 3     # 3xTF32 products on the tensor cores


def bound_s(nbytes: float, flops: float, flops_per_s: float) -> float:
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)


# --------------------------------------------------------------- kernels
def b1_cost(k: int, p: int, row_bytes: int = 4) -> tuple[float, float]:
    """(bytes, flops) of B1, the Eq. (5) partials of K client rows of P
    elements against the f32 global: each row and the global read once,
    the (K, 4) partials written once."""
    return k * p * row_bytes + p * 4 + k * 4 * 4, 5 * k * p + 2 * p


def b2_cost(k: int, p: int, row_bytes: int = 4) -> tuple[float, float]:
    """(bytes, flops) of B2, the fused Eq. (7)+(8) mix: the K weights, the
    rows and the global read once, the new (P,) global written once."""
    return k * 4 + k * p * row_bytes + p * 4 + p * 4, 2 * k * p + 3 * p


def b4_cost(b: int, s: int, h: int, kvh: int, d: int,
            elem_bytes: int = 2) -> tuple[float, float]:
    """(bytes, flops) of one causal B4 forward over q (b, s, h, d) and k/v
    (b, s, kvh, d): q, k, v read and o written once; the causal pairs'
    two products."""
    nbytes = (2 * b * s * h * d + 2 * b * s * kvh * d) * elem_bytes
    return nbytes, 4 * d * (s * (s + 1) // 2) * h * b


def b6_cost(b: int, s: int, nh: int, hd: int, ds: int,
            chunk: int) -> tuple[float, float]:
    """(bytes, flops) of one B6 forward (the SSD scan, f32): x, dt, A, B and
    C read, y and the final state written once; per chunk of L positions
    the causal pairs of W X and of C B^T and the state's products."""
    lens = [min(chunk, s - c) for c in range(0, s, chunk)]
    flops = sum(hd * n * (n + 1) * nh + 4 * n * hd * ds * nh
                + ds * n * (n + 1) for n in lens) * b
    x = b * s * nh * hd
    nbytes = 4 * (2 * x + b * s * nh + nh + 2 * b * s * ds + b * nh * hd * ds)
    return nbytes, flops


# ----------------------------------------------------------- model FLOPs
def linear_flops_per_token(cfg: dict, vocab: int) -> int:
    """Forward FLOPs a token spends in the products with weights (two a
    multiply-add): every block's projections and the unembedding over
    ``vocab`` entries.  ``cfg`` holds the configuration file's widths."""
    d, n = cfg["d_model"], cfg["n_layers"]
    if cfg["family"] == "ssm":
        din, ds = cfg["d_inner"], cfg["ssm_state"]
        nh = din // cfg["ssm_head_dim"]
        per_layer = d * (2 * din + 2 * ds + nh) + din * d
    elif cfg["family"] == "dense":
        qd = cfg["n_heads"] * cfg["head_dim"]
        kvd = cfg["n_kv_heads"] * cfg["head_dim"]
        per_layer = d * (qd + 2 * kvd) + qd * d + 3 * d * cfg["d_ff"]
    else:
        raise ValueError(f"no FLOP count for family {cfg['family']!r}")
    return 2 * (n * per_layer + d * vocab)


def core_flops(cfg: dict, b: int, s: int) -> int:
    """Forward FLOPs of the sequence mixing over ``b`` rows of ``s``
    positions, causal pairs only: the attention's two products (B4's
    count) or the SSD scan's (B6's count), every layer."""
    n = cfg["n_layers"]
    if cfg["family"] == "ssm":
        din = cfg["d_inner"]
        return n * b6_cost(b, s, din // cfg["ssm_head_dim"],
                           cfg["ssm_head_dim"], cfg["ssm_state"],
                           cfg["ssm_chunk"])[1]
    return n * b4_cost(b, s, cfg["n_heads"], cfg["n_kv_heads"],
                       cfg["head_dim"])[1]


def forward_flops(cfg: dict, b: int, s: int, vocab: int | None = None) -> int:
    """Model FLOPs of one forward pass over ``b`` x ``s`` tokens."""
    v = cfg["vocab_size"] if vocab is None else vocab
    return b * s * linear_flops_per_token(cfg, v) + core_flops(cfg, b, s)


def train_step_flops(cfg: dict, b: int, s: int) -> int:
    """Model FLOPs of one SGD step: forward and backward, three forwards'
    worth; the recompute of checkpointed layers is not counted."""
    return 3 * forward_flops(cfg, b, s)
