"""The share of a sharded prefill's per-device product FLOPs that runs
without the flash-attention kernel, for the configs whose query heads do
not divide the 16-wide "heads" axis (internvl2-1b 14, whisper-tiny 6,
recurrentgemma-2b 10): their prefill_32k cells on the 16 x 16 mesh of a
fake process group, traced on the meta device as the dry run traces them.
There each attention call shards its query rows ("qrows"), which start at
an offset the kernel does not take, so every call runs the plain
translation (``layers._attention_grouped``), on the card as here.  Prints
one markdown table row a config: the calls, the FLOPs dispatched inside
them a device, the cell's FLOPs a device and the share (the plain path's
count: full score squares, as the dry run's).

    PYTHONPATH=src python tests/torch_shard_attention_share.py
"""
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_process_group, make_mesh
from repro_torch.launch.op_cost import _OpCounter
from repro_torch.launch.specs import build_cell
from repro_torch.models import layers as L
from repro_torch.sharding import axis_rules, axis_size

ARCHS = ("internvl2-1b", "whisper-tiny", "recurrentgemma-2b")
MESH = (16, 16)


def main():
    plain, inside = L._attention_grouped, []

    def counted(*args, **kwargs):
        with _OpCounter() as ops:
            out = plain(*args, **kwargs)
        inside.append(ops.flops)
        return out

    L._attention_grouped = counted
    print("| config | plain attention calls | their FLOPs a device | the "
          "cell's FLOPs a device | share |")
    print("|---|---|---|---|---|")
    with fake_process_group(MESH[0] * MESH[1]):
        mesh = make_mesh(MESH, device_type="cpu")
        for arch in ARCHS:
            cfg = get_config(arch)
            inside.clear()
            with axis_rules(mesh):
                assert cfg.n_heads % axis_size("heads") != 0, arch
                cell = build_cell(cfg, SHAPES["prefill_32k"], mesh)
                _, cost, _, _ = D.trace_cell(cell, peak=False)
            total = cost["flops"]
            print(f"| {arch} | {len(inside)} | {sum(inside):.4e} | "
                  f"{total:.4e} | {sum(inside) / total:.4f} |", flush=True)


if __name__ == "__main__":
    main()
