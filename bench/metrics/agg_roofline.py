"""B1 and B2, the aggregation's two kernels: the least time the card could
take for the stretch's aggregations (each over its own number of rows of
P f32) over the time their kernels ran (%)."""
from bench import yardstick as Y

KERNELS = ("sim_partials_stage1", "sim_partials_stage2", "weighted_agg")


def read(rec):
    acts = rec.kernels(*KERNELS)
    rows, p = rec.counts.get("agg_rows", []), rec.counts.get("params")
    if not acts or not rows or len(rows) != rec.counts.get("b2_launches"):
        return None
    bound = sum(Y.bound_s(*Y.b1_cost(k, p), Y.F32_FLOPS_PER_S)
                + Y.bound_s(*Y.b2_cost(k, p), Y.F32_FLOPS_PER_S)
                for k in rows)
    return 100.0 * bound / rec.device_s(acts)
