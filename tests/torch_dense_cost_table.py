"""Per-device product FLOPs and collective bytes of the dense family's
smoke cells (train, prefill, decode; batch 8 x 64 positions) on the three
fake meshes of 8: the port's dry run (DTensor shards on a fake process
group) beside the reference's compiled, partitioned HLO (``hlo_cost`` and
``collective_stats``, 8 fake host devices in a subprocess).  Prints one
markdown table row a cell.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu \
        python tests/torch_dense_cost_table.py
"""
from test_torch_dryrun import DENSE, MESHES, dense_cells, jax_dense


def main():
    port = dense_cells()
    print("| mesh | config | cell | FLOPs port | FLOPs ref | collective B "
          "port | collective B ref |")
    print("|---|---|---|---|---|---|---|")
    for mesh in MESHES:
        ref = jax_dense(mesh)
        for arch in DENSE:
            for kind in ("train", "prefill", "decode"):
                p, r = port[(mesh, arch, kind)], ref[f"{arch}:{kind}"]
                print(f"| {'x'.join(map(str, mesh))} | {arch} | {kind} | "
                      f"{p['op_cost']['flops']:.0f} | {r['flops']:.0f} | "
                      f"{p['collectives']['total_bytes']} | {r['coll']} |")


if __name__ == "__main__":
    main()
