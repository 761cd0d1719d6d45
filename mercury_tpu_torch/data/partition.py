"""Non-IID data partitioning: a copy of ``partition_data`` from
``mercury_tpu/data/partition.py`` (the FedML-style per-class Dirichlet
partitioner with its capacity mask and retry-until-balanced loop). The
same seed gives the same shards in both packages (test-enforced)."""

from __future__ import annotations

from typing import List

import numpy as np


def partition_homo(n_samples: int, n_workers: int,
                   rng: np.random.Generator) -> List[np.ndarray]:
    """Random equal split."""
    idxs = rng.permutation(n_samples)
    return [np.sort(s).astype(np.int64) for s in np.array_split(idxs, n_workers)]


def partition_dirichlet(
    labels: np.ndarray,
    n_workers: int,
    alpha: float,
    rng: np.random.Generator,
    min_size: int = 10,
    max_retries: int = 1000,
) -> List[np.ndarray]:
    """Per-class Dirichlet(α) split; a worker already holding N/n samples
    gets none of the next class; retried until every shard holds at least
    ``min_size`` samples."""
    labels = np.asarray(labels)
    n = labels.shape[0]
    classes = np.unique(labels)
    target = n / n_workers
    for _ in range(max_retries):
        shards: List[List[np.ndarray]] = [[] for _ in range(n_workers)]
        sizes = np.zeros(n_workers, dtype=np.int64)
        for k in classes:
            idx_k = np.flatnonzero(labels == k)
            rng.shuffle(idx_k)
            proportions = rng.dirichlet(np.repeat(alpha, n_workers))
            proportions = proportions * (sizes < target)
            s = proportions.sum()
            if s == 0:
                proportions = np.full(n_workers, 1.0 / n_workers)
            else:
                proportions = proportions / s
            cuts = (np.cumsum(proportions) * len(idx_k)).astype(int)[:-1]
            for w, part in enumerate(np.split(idx_k, cuts)):
                shards[w].append(part)
                sizes[w] += len(part)
        if sizes.min() >= min_size:
            return [np.sort(np.concatenate(s)).astype(np.int64) for s in shards]
    raise RuntimeError(
        f"Dirichlet partition failed to reach min shard size {min_size} "
        f"after {max_retries} retries (α={alpha}, workers={n_workers})"
    )


def partition_data(
    labels: np.ndarray,
    n_workers: int,
    mode: str = "hetero",
    alpha: float = 0.5,
    seed: int = 102,
    min_size: int = 10,
) -> List[np.ndarray]:
    """``"homo"`` (IID) or ``"hetero"`` (Dirichlet non-IID): a list of
    sorted, disjoint global-index arrays, one per worker."""
    rng = np.random.default_rng(seed)
    n = int(np.asarray(labels).shape[0])
    if mode == "homo":
        return partition_homo(n, n_workers, rng)
    if mode == "hetero":
        return partition_dirichlet(labels, n_workers, alpha, rng,
                                   min_size=min_size)
    raise ValueError(f"unknown partition mode {mode!r} (use 'homo' or 'hetero')")
