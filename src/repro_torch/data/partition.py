"""Non-IID client partitioning (paper §III / §VI: Dirichlet concentration).

dirichlet_partition replicates the standard label-skew protocol [Li et al.,
ICDE'22] the paper cites: per class c, sample a distribution over clients
~ Dir(alpha) and split class-c samples proportionally.
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_size: int = 2) -> list[np.ndarray]:
    """Returns per-client index arrays covering all samples exactly once."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    while True:
        idx_per_client: list[list[int]] = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            props = rng.dirichlet([alpha] * n_clients)
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for cid, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[cid].extend(part.tolist())
        sizes = [len(ix) for ix in idx_per_client]
        if min(sizes) >= min_size:
            break
        alpha *= 1.5        # re-draw with milder skew until feasible
    return [np.asarray(sorted(ix), np.int64) for ix in idx_per_client]


def iid_partition(n_samples: int, n_clients: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_samples)
    return [np.sort(p) for p in np.array_split(perm, n_clients)]
