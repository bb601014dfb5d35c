"""Wrapper around the native clustering extension.

Raises ImportError when the extension is not built, which makes
:func:`humid_tpu_torch.cluster.exact.cluster_exact` fall back to the
pure Python implementation (same semantics, slower).
Build with: python setup.py build_ext --inplace
"""

from __future__ import annotations

import numpy as np

from . import _ccluster


def cluster(counts, indptr, indices, maximum, parallel=False):
    """Native CSR clustering; mirrors the pure-Python version in
    humid_tpu_torch/cluster/exact.py (semantics of cluster.cc).

    ``parallel`` runs the component-parallel variant
    (``cluster_parallel_into``: union-find the components, the same walk
    per component under OpenMP, clusters renumbered by seed rank); the
    output is bit-identical."""
    u = len(counts)
    labels = np.zeros(u, dtype=np.int64)
    cap = max(u, 1)
    max_leaf = np.empty(cap, dtype=np.int64)
    max_count = np.empty(cap, dtype=np.int64)
    size = np.empty(cap, dtype=np.int64)
    k = 0
    if u:
        fn = (_ccluster.cluster_parallel_into if parallel
              else _ccluster.cluster_into)
        k = fn(counts, indptr, indices, bool(maximum),
               labels, max_leaf, max_count, size)
    return labels, max_leaf[:k].copy(), max_count[:k].copy(), size[:k].copy()


def cluster_masked(counts, indptr, indices, maximum, own):
    """Exact walk restricted to the seeds of owned components (``own``:
    uint8 [u]); walks never leave their component, so this equals
    clustering the owned components' induced subgraph without building
    one.  Returns (labels [u] local ids 0 / 1..k, seeds [k], max_leaf
    [k], max_count [k], size [k]), seeds and max_leaf global indices."""
    u = len(counts)
    labels = np.zeros(u, dtype=np.int64)
    cap = max(u, 1)
    seeds = np.empty(cap, dtype=np.int64)
    max_leaf = np.empty(cap, dtype=np.int64)
    max_count = np.empty(cap, dtype=np.int64)
    size = np.empty(cap, dtype=np.int64)
    k = 0
    if u:
        k = _ccluster.cluster_masked_into(
            np.ascontiguousarray(counts, np.int64),
            np.ascontiguousarray(indptr, np.int64),
            np.ascontiguousarray(indices, np.int64), bool(maximum),
            np.ascontiguousarray(own, np.uint8), labels, seeds,
            max_leaf, max_count, size)
    return (labels, seeds[:k].copy(), max_leaf[:k].copy(),
            max_count[:k].copy(), size[:k].copy())


def components(pa, pb, u):
    """Connected-component labels (the smallest node index of each
    component) of an (a, b) edge list over ``u`` nodes: one native
    O(u + E) union-find pass.  The native pass indexes its parent array
    by the endpoints unchecked, so every endpoint is checked against
    [0, u) here first; a bad one raises ValueError."""
    a = np.ascontiguousarray(pa, np.int64)
    b = np.ascontiguousarray(pb, np.int64)
    if len(a) != len(b):
        raise ValueError(f"edge lists differ in length: {len(a)} and "
                         f"{len(b)}")
    for name, x in (("a", a), ("b", b)):
        if len(x) and (int(x.min()) < 0 or int(x.max()) >= u):
            bad = int(np.flatnonzero((x < 0) | (x >= u))[0])
            raise ValueError(f"edge {bad}: endpoint {name}={int(x[bad])} "
                             f"outside [0, {u})")
    labels = np.empty(u, dtype=np.int64)
    _ccluster.components_into(a, b, labels)
    return labels
