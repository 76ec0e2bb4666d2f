"""Per-device product FLOPs and collective bytes of the smoke cells (train,
prefill, decode; batch 8 x 64 positions) of every config (the dense
family's, internvl2-1b, whisper-tiny, recurrentgemma-2b, mamba2-1.3b,
mixtral-8x22b and deepseek-v2-lite-16b) on the three fake meshes of 8:
the port's dry run (DTensor shards on a fake process group) beside the
reference's compiled, partitioned HLO (``hlo_cost`` and
``collective_stats``, 8 fake host devices in a subprocess), and the
FLOPs that the port computes on each rank for its own rows beyond XLA's
split of them: the SSD scan's C B^T, which XLA spreads over the "model"
ranks (``ssd_cb_flops``), and the moe configs' router product, of which
XLA splits some over "model" (``router_flops`` less XLA's router
products).
Prints one markdown table row a cell.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu \
        python tests/torch_dense_cost_table.py
"""
from test_torch_dryrun import (DECODE, MESHES, PREFILL, SHARDED, TRAIN,
                               _mesh_sizes, dense_cells, jax_dense,
                               router_flops, ssd_cb_flops)
from test_torch_dryrun_moe import jax_moe, moe_cells
from repro_torch.configs import smoke_config

MOES = ("mixtral-8x22b", "deepseek-v2-lite-16b")


def main():
    port = dense_cells()
    moe = {arch: moe_cells(arch=arch) for arch in MOES}
    shapes = {"train": TRAIN, "prefill": PREFILL, "decode": DECODE}
    print("| mesh | config | cell | FLOPs port | FLOPs ref | own rows beyond "
          "XLA's share | collective B port | collective B ref |")
    print("|---|---|---|---|---|---|---|---|")
    for mesh in MESHES:
        ref = jax_dense(mesh)
        for arch in MOES:
            ref.update({f"{arch}:{k}": v
                        for k, v in jax_moe(mesh, arch).items()})
        dp, n_h = _mesh_sizes(mesh)
        for arch in SHARDED + MOES:
            cfg = smoke_config(arch)
            for kind in ("train", "prefill", "decode"):
                r = ref[f"{arch}:{kind}"]
                if arch in MOES:
                    p = moe[arch][(mesh, kind)]
                    own = (router_flops(cfg, shapes[kind], dp)
                           - r["router_dot_flops"])
                else:
                    p = port[(mesh, arch, kind)]
                    cb = ssd_cb_flops(cfg, shapes[kind], dp)
                    own = cb - cb // n_h
                print(f"| {'x'.join(map(str, mesh))} | {arch} | {kind} | "
                      f"{p['op_cost']['flops']:.0f} | {r['flops']:.0f} | "
                      f"{own:.0f} | {p['collectives']['total_bytes']} | "
                      f"{r['coll']} |")


if __name__ == "__main__":
    main()
