"""The share of a sharded prefill's per-device product FLOPs that runs
without the flash-attention kernel, for the configs whose query heads do
not divide the 16-wide "heads" axis (internvl2-1b 14, whisper-tiny 6,
recurrentgemma-2b 10), for mixtral-8x22b (48 heads, "repeat_kv") and for
deepseek-v2-lite-16b (16 heads, but MLA's attention shards its query rows,
"qrows", as the reference's does whatever the heads):
their prefill_32k cells on the 16 x 16 mesh of a fake process group,
traced on the meta device as the dry run traces them, each attention
call routed as on the card (``layers._uses_flash_kernel``, its device
test ``layers._flash_on_device`` taking the CPU).  Where the heads do
not divide, each attention call shards its query rows ("qrows"), which
start at an offset the kernel does not take, so every call runs the
plain translation (``layers._attention_grouped``), on the card as here,
and so do deepseek's; mixtral's calls take the kernel's route on each
rank's 3 local heads
(here its plain version stands in, counted apart).  Prints one markdown table row a
config: the plain calls, the kernel route's calls, the FLOPs dispatched
inside the plain calls a device, the cell's FLOPs a device and the share
(the plain path's count: full score squares, as the dry run's).

    PYTHONPATH=src python tests/torch_shard_attention_share.py
"""
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_process_group, make_mesh
from repro_torch.launch.op_cost import _OpCounter
from repro_torch.launch.specs import build_cell
from repro_torch.models import layers as L
from repro_torch.sharding import axis_rules, axis_size

ARCHS = ("internvl2-1b", "whisper-tiny", "recurrentgemma-2b",
         "mixtral-8x22b", "deepseek-v2-lite-16b")
MESH = (16, 16)


def main():
    plain, inside, kernel = L._attention_grouped, [], []

    def counted(*args, **kwargs):
        with _OpCounter() as ops:
            out = plain(*args, **kwargs)
        inside.append(ops.flops)
        return out

    def on_kernel(qg, k, v, causal, window, q_chunk):
        kernel.append(1)
        return plain(qg, k, v, causal=causal, window=window,
                     q_chunk=q_chunk, remat_chunks=False)

    L._attention_grouped, L._flash_grouped = counted, on_kernel
    L._flash_on_device = lambda q: True
    print("| config | plain attention calls | kernel route calls | their "
          "FLOPs a device (plain) | the cell's FLOPs a device | share |")
    print("|---|---|---|---|---|---|")
    with fake_process_group(MESH[0] * MESH[1]):
        mesh = make_mesh(MESH, device_type="cpu")
        for arch in ARCHS:
            cfg = get_config(arch)
            inside.clear()
            kernel.clear()
            with axis_rules(mesh):
                divides = cfg.n_heads % axis_size("heads") == 0
                assert cfg.use_mla or divides == (
                    cfg.attn_score_shard == "repeat_kv"), arch
                cell = build_cell(cfg, SHAPES["prefill_32k"], mesh)
                _, cost, _, _ = D.trace_cell(cell, peak=False)
            total = cost["flops"]
            print(f"| {arch} | {len(inside)} | {len(kernel)} | "
                  f"{sum(inside):.4e} | {total:.4e} | "
                  f"{sum(inside) / total:.4f} |", flush=True)


if __name__ == "__main__":
    main()
