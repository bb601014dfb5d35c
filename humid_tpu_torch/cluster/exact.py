"""Bit-exact clustering, reproducing the reference's traversal semantics.

The reference's two methods (cluster.cc):

* Maximum (-x): recursive flood fill of the connected component; every leaf
  visited updates maxCount/maxLeaf with STRICT ``>`` — ties keep the
  earlier leaf in DFS pre-order (cluster.cc:20-25, 72-80).
* Directional (default, UMI-tools style):
    1. hill-climb ``maxNeighbour_``: scan neighbours in list order, jump to
       the FIRST unassigned neighbour with count >= 2*current and restart
       the scan; repeat until stuck (cluster.cc:39-51).
    2. ``updateMaxCount_`` once on the hill-climb result (cluster.cc:84-85).
    3. recursive descent from that local max absorbing unassigned
       neighbours with leaf.count >= 2*neighbour.count (cluster.cc:58-69).

Seeds iterate in trie-walk (lexicographic) order (humid.cc:178); ids start
at 1 (humid.cc:177).  With unique words sorted ascending and CSR neighbour
lists ascending (see humid_tpu_torch.ops.neighbors), this module replays
the exact same visit order iteratively with an explicit stack.

A C++ fast path (csrc/cluster.cpp) implements the same algorithm for large
graphs; this numpy/python version is the always-available fallback and the
test oracle for the native one.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

try:
    from . import _native
except ImportError:  # pragma: no cover - extension not built
    _native = None


@dataclass
class ClusterResult:
    """Per-node cluster ids (1-based; 0 = unassigned, never final) and
    per-cluster tables indexed by cluster id - 1."""

    labels: np.ndarray      # [U] int64 cluster id per unique word
    max_leaf: np.ndarray    # [K] int64 node index of cluster->maxLeaf
    max_count: np.ndarray   # [K] int64 cluster->maxCount
    size: np.ndarray        # [K] int64 cluster->size (sum of member counts)

    @property
    def num_clusters(self) -> int:
        return len(self.size)


#: $HUMID_TPU_TORCH_CLUSTER: "parallel" or "seq" set ``parallel=None`` of
#: :func:`cluster_exact` ("device" is read by ``pipeline.cluster_dispatch``).
CLUSTER_ENV_VAR = "HUMID_TPU_TORCH_CLUSTER"
#: ``parallel=None`` without the variable: never parallel.  The
#: reference's measurement (its ``_PARALLEL_AUTO``) found the
#: component-parallel walk's fixed cost growing with the table on every
#: core count; on an H100's host built with OpenMP, ``chip_smoke.py``
#: phase 33 times it against the sequential walk (PERF.md).
PARALLEL_AUTO = False


def cluster_exact(
    counts: np.ndarray,
    indptr: np.ndarray,
    indices: np.ndarray,
    *,
    maximum: bool = False,
    use_native: bool = True,
    parallel: bool | None = None,
) -> ClusterResult:
    """Cluster unique words given exact-duplicate ``counts`` and CSR
    adjacency (ascending neighbour lists).

    With the native extension, ``parallel=True`` (or, for None,
    $HUMID_TPU_TORCH_CLUSTER=parallel) takes the component-parallel walk:
    clusters in distinct connected components cannot interact, so they
    are walked concurrently and renumbered by seed rank; the output is
    bit-identical.  ``parallel=False`` (or "seq") and the default take the
    sequential walk (:data:`PARALLEL_AUTO`).  Without the extension the
    Python walk runs either way."""
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    if use_native and _native is not None:
        if parallel is None:
            env = os.environ.get(CLUSTER_ENV_VAR, "auto")
            parallel = (True if env == "parallel"
                        else False if env in ("seq", "sequential")
                        else PARALLEL_AUTO)
        return ClusterResult(*_native.cluster(counts, indptr, indices,
                                              bool(maximum),
                                              parallel=bool(parallel)))
    if maximum:
        return _cluster_max_py(counts, indptr, indices)
    return _cluster_directional_py(counts, indptr, indices)


def cluster_max_from_components(
    counts: np.ndarray,
    indptr: np.ndarray,
    indices: np.ndarray,
    cc_labels: np.ndarray,
) -> ClusterResult:
    """Finish maximum (-x) clustering from connected-component labels
    (smallest node index per component, e.g. from
    :func:`.labelprop.connected_components_device`), equal to
    :func:`cluster_exact`'s DFS (cluster.cc:72-80).

    Membership, ids in seed order, ``size`` and ``maxCount`` do not depend
    on the visit order.  ``maxLeaf`` does: the reference's strict ``>``
    keeps the first max-count leaf in DFS pre-order, which is ambiguous
    only when several members share the max count.  Those components are
    walked again with the same DFS, stopping at the first max-count node;
    no other component touches the adjacency."""
    from .labelprop import renumber_components

    counts = np.ascontiguousarray(counts, dtype=np.int64)
    u = len(counts)
    cid, k, seeds = renumber_components(cc_labels)
    if k == 0:
        z = np.zeros(0, np.int64)
        return ClusterResult(np.zeros(0, np.int64), z, z, z)
    g = cid - 1
    size = np.bincount(g, weights=counts, minlength=k).astype(np.int64)
    max_count = np.zeros(k, np.int64)
    np.maximum.at(max_count, g, counts)
    # The first max in index order: the DFS's first when the max is
    # unique in its component.
    is_max = counts == max_count[g]
    n_max = np.bincount(g[is_max], minlength=k)
    max_leaf = np.full(k, u, np.int64)
    np.minimum.at(max_leaf, g[is_max], np.flatnonzero(is_max))
    for comp in np.flatnonzero(n_max > 1).tolist():
        mc = int(max_count[comp])
        seed = int(seeds[comp])
        if counts[seed] == mc:  # pre-order starts at the seed
            max_leaf[comp] = seed
            continue
        # Pre-order DFS over ascending adjacency, stopping at the first
        # max-count node (the strict > never replaces it).
        visited = {seed}
        stack = [(seed, int(indptr[seed]))]
        while stack:
            node, ptr = stack[-1]
            if ptr == indptr[node + 1]:
                stack.pop()
                continue
            stack[-1] = (node, ptr + 1)
            nb = int(indices[ptr])
            if nb not in visited:
                visited.add(nb)
                if counts[nb] == mc:
                    max_leaf[comp] = nb
                    break
                stack.append((nb, int(indptr[nb])))
    return ClusterResult(cid, max_leaf, max_count, size)


def _cluster_max_py(counts, indptr, indices) -> ClusterResult:
    u = len(counts)
    labels = np.zeros(u, dtype=np.int64)
    max_leaf: list[int] = []
    max_count: list[int] = []
    sizes: list[int] = []
    for seed in range(u):
        if labels[seed]:
            continue
        cid = len(sizes) + 1
        ml, mc, size = -1, 0, 0
        # Iterative pre-order DFS == the recursion in cluster.cc:72-80:
        # assign + updateMaxCount on entry, then neighbours in list order.
        labels[seed] = cid
        size += counts[seed]
        if counts[seed] > mc:
            mc, ml = counts[seed], seed
        stack = [(seed, indptr[seed])]
        while stack:
            node, ptr = stack[-1]
            if ptr == indptr[node + 1]:
                stack.pop()
                continue
            stack[-1] = (node, ptr + 1)
            nb = indices[ptr]
            if labels[nb] == 0:
                labels[nb] = cid
                size += counts[nb]
                if counts[nb] > mc:
                    mc, ml = counts[nb], nb
                stack.append((nb, indptr[nb]))
        max_leaf.append(int(ml))
        max_count.append(int(mc))
        sizes.append(int(size))
    return ClusterResult(
        labels,
        np.asarray(max_leaf, np.int64),
        np.asarray(max_count, np.int64),
        np.asarray(sizes, np.int64),
    )


def _cluster_directional_py(counts, indptr, indices) -> ClusterResult:
    u = len(counts)
    labels = np.zeros(u, dtype=np.int64)
    max_leaf: list[int] = []
    max_count: list[int] = []
    sizes: list[int] = []
    for seed in range(u):
        if labels[seed]:
            continue
        cid = len(sizes) + 1
        # Hill climb (cluster.cc:39-51): restart the scan after every jump.
        node = seed
        i = indptr[node]
        end = indptr[node + 1]
        while i < end:
            nb = indices[i]
            i += 1
            if labels[nb] == 0 and counts[nb] >= 2 * counts[node]:
                node = nb
                i = indptr[node]
                end = indptr[node + 1]
        # updateMaxCount_ once on the local max (cluster.cc:84-85); the
        # cluster starts with maxCount 0 so the local max always wins.
        ml, mc = int(node), int(counts[node])
        size = 0
        # Descent (cluster.cc:58-69): assign on entry; absorb unassigned
        # neighbours with current.count >= 2*neighbour.count.
        labels[node] = cid
        size += counts[node]
        stack = [(node, indptr[node])]
        while stack:
            cur, ptr = stack[-1]
            if ptr == indptr[cur + 1]:
                stack.pop()
                continue
            stack[-1] = (cur, ptr + 1)
            nb = indices[ptr]
            if labels[nb] == 0 and counts[cur] >= 2 * counts[nb]:
                labels[nb] = cid
                size += counts[nb]
                stack.append((nb, indptr[nb]))
        max_leaf.append(ml)
        max_count.append(mc)
        sizes.append(int(size))
    return ClusterResult(
        labels,
        np.asarray(max_leaf, np.int64),
        np.asarray(max_count, np.int64),
        np.asarray(sizes, np.int64),
    )
