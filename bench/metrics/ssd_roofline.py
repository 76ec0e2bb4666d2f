"""B6, the SSD scan's forward kernels: the least time the card could take
for the stretch's calls over the time its kernels ran (%).  The calls are
counted from the traffic (two a layer a training step: the forward and
its recompute; one a layer an evaluation) and must equal the program's
launch counter."""
from bench import yardstick as Y

KERNELS = ("ssd_chunk_cb", "ssd_chunk_state", "ssd_state_pass",
           "ssd_chunk_scan")


def read(rec):
    m, tr = rec.cell["model"], rec.cell["traffic"]
    acts = rec.kernels(*KERNELS)
    if m["family"] != "ssm" or not acts:
        return None
    n, s = m["n_layers"], tr["seq_len"]
    calls = [(tr["batch"], 2 * n * rec.counts["sgd_steps"]),
             (tr["eval_seqs"], n * rec.counts["evals"])]
    if sum(c for _, c in calls) != rec.counts.get("b6_launches"):
        return None
    nh = m["d_inner"] // m["ssm_head_dim"]
    bound = sum(c * Y.bound_s(*Y.b6_cost(b, s, nh, m["ssm_head_dim"],
                                         m["ssm_state"], m["ssm_chunk"]),
                              Y.F32_TC_FLOPS_PER_S) for b, c in calls)
    return 100.0 * bound / rec.device_s(acts)
