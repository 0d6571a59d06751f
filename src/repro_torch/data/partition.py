"""Non-IID data partitioning (paper §V-B.1: Dirichlet with α=2.0)."""
from __future__ import annotations

import numpy as np


def dirichlet_partition(
    labels: np.ndarray,
    num_clients: int,
    alpha: float,
    seed: int = 0,
    min_per_client: int = 2,
) -> list[np.ndarray]:
    """Partition sample indices over clients with per-class Dirichlet(α)
    proportions (Li et al., ICDE'22 — the scheme FedML uses).

    Returns a list of index arrays, one per client; every client is
    guaranteed at least ``min_per_client`` samples.
    """
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    client_idx: list[list[int]] = [[] for _ in range(num_clients)]
    for c in range(num_classes):
        idx_c = np.flatnonzero(labels == c)
        rng.shuffle(idx_c)
        props = rng.dirichlet([alpha] * num_clients)
        cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
        for i, part in enumerate(np.split(idx_c, cuts)):
            client_idx[i].extend(part.tolist())

    # rebalance clients that fell below the minimum
    sizes = np.array([len(ix) for ix in client_idx])
    for i in np.flatnonzero(sizes < min_per_client):
        donor = int(np.argmax([len(ix) for ix in client_idx]))
        need = min_per_client - len(client_idx[i])
        for _ in range(need):
            client_idx[i].append(client_idx[donor].pop())
    out = [np.asarray(sorted(ix), np.int64) for ix in client_idx]
    assert sum(len(ix) for ix in out) == len(labels)
    return out


def iid_partition(n: int, num_clients: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [np.sort(p) for p in np.array_split(perm, num_clients)]
