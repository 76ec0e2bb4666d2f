from repro_torch.kernels.seafl_agg.ops import (
    similarity_partials, similarity_partials_from_params,
    weighted_aggregate, seafl_aggregate_flat, seafl_aggregate_flat_from_params,
    fedavg_aggregate_flat, fedbuff_aggregate_flat, fedasync_aggregate_flat,
)

__all__ = [
    "similarity_partials", "similarity_partials_from_params",
    "weighted_aggregate", "seafl_aggregate_flat",
    "seafl_aggregate_flat_from_params", "fedavg_aggregate_flat",
    "fedbuff_aggregate_flat", "fedasync_aggregate_flat",
]
