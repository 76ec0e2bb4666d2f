"""Per-device product FLOPs and collective bytes of the smoke cells (train,
prefill, decode; batch 8 x 64 positions) of every config whose LM runs on
shards (the dense family's, internvl2-1b, whisper-tiny,
recurrentgemma-2b and mamba2-1.3b) on the three fake meshes of 8: the
port's dry run (DTensor shards on a fake process group) beside the
reference's compiled, partitioned HLO (``hlo_cost`` and
``collective_stats``, 8 fake host devices in a subprocess), and the
FLOPs of the SSD scan's C B^T that the port computes on each rank for
its own rows and XLA spreads over the "model" ranks
(``ssd_cb_flops``).  Prints one markdown table row a cell.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu \
        python tests/torch_dense_cost_table.py
"""
from test_torch_dryrun import (DECODE, MESHES, PREFILL, SHARDED, TRAIN,
                               _mesh_sizes, dense_cells, jax_dense,
                               ssd_cb_flops)
from repro_torch.configs import smoke_config


def main():
    port = dense_cells()
    shapes = {"train": TRAIN, "prefill": PREFILL, "decode": DECODE}
    print("| mesh | config | cell | FLOPs port | FLOPs ref | C B^T beyond "
          "XLA's share | collective B port | collective B ref |")
    print("|---|---|---|---|---|---|---|---|")
    for mesh in MESHES:
        ref = jax_dense(mesh)
        dp, n_h = _mesh_sizes(mesh)
        for arch in SHARDED:
            for kind in ("train", "prefill", "decode"):
                p, r = port[(mesh, arch, kind)], ref[f"{arch}:{kind}"]
                cb = ssd_cb_flops(smoke_config(arch), shapes[kind], dp)
                print(f"| {'x'.join(map(str, mesh))} | {arch} | {kind} | "
                      f"{p['op_cost']['flops']:.0f} | {r['flops']:.0f} | "
                      f"{cb - cb // n_h} | "
                      f"{p['collectives']['total_bytes']} | {r['coll']} |")


if __name__ == "__main__":
    main()
