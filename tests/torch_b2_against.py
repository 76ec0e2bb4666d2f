"""B2 (``weighted_agg``) of this tree against B2 built from another
``seafl_agg.cu``, bit for bit, on the card: for a change to B2 that must
keep its bits (such as a new argument), with the other tree's source
taken from a checkout of it.

    python tests/torch_b2_against.py \
        <other tree>/src/repro_torch/kernels/seafl_agg/csrc/seafl_agg.cu

The other source's entry point is ``seafl_weighted_agg`` with theta and
no keep factor (the port's B2 before the pod-sharded route).  Each of 64
cases (phase e's (10, 11,176,970) and three ragged shapes, f32 and bf16
rows, f32 and bf16 globals, theta 0.8, 1.0, 0.5 and 0.0) runs both on the
same inputs; prints the cases that differ and exits non-zero if any
does.  Needs a CUDA card and nvcc.
"""
import ctypes
import itertools
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels._common import DTYPES, stream  # noqa: E402
from repro_torch.kernels.seafl_agg import kernel as K  # noqa: E402

SHAPES = ((C.MAIN_K, C.RESNET18_P), (33, 70_001), (1, 100), (7, 5000))


def main(other: str) -> int:
    if not torch.cuda.is_available():
        print("torch_b2_against: no CUDA card", file=sys.stderr)
        return 2
    kernels.SOURCES["seafl_agg_other"] = Path(other).resolve()
    lib = kernels.build_all(["seafl_agg", "seafl_agg_other"])[
        "seafl_agg_other"]
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.seafl_weighted_agg.argtypes = [vp, vp, i, vp, i, i, ll,
                                       ctypes.c_float, vp, i, vp]
    lib.seafl_weighted_agg.restype = i
    bad, n = [], 0
    f32, bf16 = torch.float32, torch.bfloat16
    for (k, p), wd, gd, theta in itertools.product(
            SHAPES, (f32, bf16), (f32, bf16), (0.8, 1.0, 0.5, 0.0)):
        w, g, wts = C._inputs(torch, k, p, wd, gd, seed=n)
        new = K.weighted_agg_call(wts, w, g, theta)
        old = torch.empty_like(g)
        K._check_cuda("seafl_weighted_agg", lib.seafl_weighted_agg(
            wts.data_ptr(), w.data_ptr(), DTYPES[wd], g.data_ptr(),
            DTYPES[gd], k, p, float(theta), old.data_ptr(), K._grid(p),
            stream(g.device)))
        torch.cuda.synchronize()
        n += 1
        if not torch.equal(new, old):
            bad.append((k, p, str(wd), str(gd), theta,
                        int((new != old).sum())))
    print(f"[b2] this tree's B2 against {other}'s: {n} cases, {len(bad)} "
          f"differ {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
