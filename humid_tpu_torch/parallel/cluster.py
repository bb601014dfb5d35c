"""Host-sharded clustering: ~1/P of the walk on each process, the global
result bit for bit.

Counterpart of ``humid_tpu/parallel/cluster.py``.  Clusters in different
connected components never interact, and a cluster's members are a
reachability closure (csrc/cluster.cpp:125-137), so:

  1. every process finds the connected components of the merged edge
     list (min-node labels; shared input, no communication);
  2. a component is owned by the salted hash of its min node
     (``ops.neighbors._owned_mask``, salt ``_COMP_SALT``), the same on
     every process;
  3. each process runs the exact sequential walk over its owned
     components only; ownership is per component and walks never leave
     theirs, so per-component results equal the full-table walk
     (cluster.cc:39-87 semantics);
  4. per-cluster rows (seed, maxLeaf, maxCount, size) and per-node seeds
     are gathered; global ids are the ascending rank of the seed node,
     the reference's id order (a cluster's seed is the smallest node no
     earlier cluster absorbed).

Unlike the reference, the per-node seeds are always gathered, so the
merged result carries the full [U] labels on every route.
"""

from __future__ import annotations

import numpy as np

from ..cluster.exact import ClusterResult, cluster_exact

__all__ = ["cluster_sharded_local", "cluster_sharded_merge",
           "cluster_sharded"]

#: Salt index of the component-ownership hash (apart from the pigeonhole
#: partitions' salts, which are their partition indices).
_COMP_SALT = 101


def _empty_local():
    z = np.zeros(0, np.int64)
    return z, z, z, z, np.zeros((0, 2), np.int64)


def cluster_sharded_local(counts, indptr, indices, pa, pb, *,
                          maximum: bool, shard: tuple[int, int],
                          device=None):
    """This process's owned-component clustering.

    Returns the five arrays of the gather, in global node indices: owned
    nodes [n_p], each owned node's cluster seed [n_p], and per cluster
    the seed, maxLeaf and (maxCount, size) ([k_p], [k_p], [k_p, 2]).
    With the native extension the components come from its union-find
    and the walk is its masked walk over the whole CSR; without it, from
    label propagation on ``device`` and the exact walk over the owned
    components' induced subgraph (:func:`_local_subgraph`)."""
    if len(counts) == 0:
        return _empty_local()
    try:
        from ..cluster._native import cluster_masked, components
    except ImportError:  # extension not built
        return _local_subgraph(counts, indptr, indices, pa, pb,
                               maximum=maximum, shard=shard, device=device)
    from ..ops.neighbors import _owned_mask

    comp = components(pa, pb, len(counts))
    own = _owned_mask(comp.astype(np.uint64), shard,
                      salt_idx=_COMP_SALT).astype(np.uint8)
    labels_loc, seeds, ml, mc, sz = cluster_masked(
        counts, indptr, indices, maximum, own)
    owned_nodes = np.flatnonzero(labels_loc).astype(np.int64)
    node_seed = seeds[labels_loc[owned_nodes] - 1]
    return (owned_nodes, node_seed.astype(np.int64), seeds, ml,
            np.stack([mc, sz], axis=1).astype(np.int64).reshape(-1, 2))


def _local_subgraph(counts, indptr, indices, pa, pb, *, maximum, shard,
                    device=None):
    """Extension-less local step: components by label propagation on
    ``device``, read back and hashed on the host (:func:`_owned_mask`),
    and the exact walk over the owned components' induced subgraph; the
    ascending renumbering keeps seed and visit order the full table's."""
    from .._util import concat_aranges
    from ..cluster.labelprop import components_tensor
    from ..ops.neighbors import _owned_mask

    comp = components_tensor(pa, pb, len(counts), device).cpu().numpy()
    owned_nodes = np.flatnonzero(
        _owned_mask(comp.astype(np.uint64), shard, salt_idx=_COMP_SALT))
    if not len(owned_nodes):
        return _empty_local()
    deg = indptr[1:] - indptr[:-1]
    deg_o = deg[owned_nodes]
    indptr2 = np.concatenate([[0], np.cumsum(deg_o)]).astype(np.int64)
    if int(indptr2[-1]):
        offs = np.repeat(indptr[owned_nodes], deg_o)
        indices2 = np.searchsorted(
            owned_nodes, indices[offs + concat_aranges(deg_o)])
    else:
        indices2 = np.zeros(0, np.int64)
    cl = cluster_exact(counts[owned_nodes], indptr2, indices2,
                       maximum=maximum)
    seeds_local = np.full(cl.num_clusters, len(owned_nodes), np.int64)
    np.minimum.at(seeds_local, cl.labels - 1,
                  np.arange(len(owned_nodes), dtype=np.int64))
    seeds = owned_nodes[seeds_local]
    return (owned_nodes, seeds[cl.labels - 1].astype(np.int64),
            seeds.astype(np.int64), owned_nodes[cl.max_leaf],
            np.stack([cl.max_count, cl.size], axis=1).astype(np.int64))


def cluster_sharded_merge(u: int, gathered) -> ClusterResult:
    """Merge every process's gathered local results into the global
    ClusterResult (the same on every process)."""
    nodes_all, node_seed_all, seeds_all, ml_all, mcsz_all = gathered
    cat = lambda xs: (np.concatenate([np.asarray(x, np.int64) for x in xs])
                      if len(xs) else np.zeros(0, np.int64))
    seeds, ml = cat(seeds_all), cat(ml_all)
    mcsz = np.concatenate([np.asarray(x, np.int64).reshape(-1, 2)
                           for x in mcsz_all])
    # Global ids: the ascending rank of the seed node (reference order).
    order = np.argsort(seeds, kind="stable")
    labels = np.zeros(u, np.int64)
    nodes = cat(nodes_all)
    if len(nodes):
        labels[nodes] = np.searchsorted(seeds[order],
                                        cat(node_seed_all)) + 1
    return ClusterResult(labels, ml[order], mcsz[order, 0], mcsz[order, 1])


def cluster_sharded(counts, indptr, indices, pa, pb, *, maximum: bool,
                    shard: tuple[int, int], all_gather,
                    device=None) -> ClusterResult:
    """Distributed cluster phase: the local owned-component clustering,
    one gather, the deterministic merge.  Each process walks ~1/P of the
    table; the components pass and the merge are the shared O(u + E)
    remainder."""
    local = cluster_sharded_local(counts, indptr, indices, pa, pb,
                                  maximum=maximum, shard=shard,
                                  device=device)
    return cluster_sharded_merge(len(counts), all_gather(list(local)))
