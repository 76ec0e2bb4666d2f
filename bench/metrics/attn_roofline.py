"""B4, flash attention's forward kernel: the least time the card could
take for the stretch's causal calls over the time its kernels ran (%).
The calls are counted from the traffic (two a layer a training step, one
a layer an evaluation) and must equal the program's launch counter."""
from bench import yardstick as Y

KERNELS = ("flash_tc_kernel", "flash_mma_kernel")


def read(rec):
    m, tr = rec.cell["model"], rec.cell["traffic"]
    acts = rec.kernels(*KERNELS)
    if m["family"] != "dense" or not acts:
        return None
    n, s = m["n_layers"], tr["seq_len"]
    calls = [(tr["batch"], 2 * n * rec.counts["sgd_steps"]),
             (tr["eval_seqs"], n * rec.counts["evals"])]
    if sum(c for _, c in calls) != rec.counts.get("b4_launches"):
        return None
    bound = sum(c * Y.bound_s(*Y.b4_cost(b, s, m["n_heads"],
                                         m["n_kv_heads"], m["head_dim"]),
                              Y.BF16_FLOPS_PER_S) for b, c in calls)
    return 100.0 * bound / rec.device_s(acts)
