"""Directional clustering on the device, equal to the host walk.

The reference's directional method (cluster.cc:39-87) is sequential
across the clusters of one connected component: every hill-climb and
descent reads the "unassigned" state that earlier clusters wrote.
Clusters of different components never interact, so one device ROUND
finishes the next cluster of every component at once, and the outer loop
runs as many rounds as the longest chain of clusters in one component.

Within a round everything is bounded and independent of visit order:

* the seed of each component is its smallest unassigned node (a
  scatter-min): the reference's first unassigned leaf in lexicographic
  walk order (humid.cc:177-180), because unique tables ascend;
* the hill-climb jumps to the first (smallest-index, as CSR neighbour
  lists ascend) unassigned neighbour with count >= 2 x the current one
  (cluster.cc:39-51).  Each jump at least doubles the count, so 31
  sweeps cover every count below 2^31; a sweep is one masked scatter-min
  over the edges;
* the local max founds the cluster; the descent absorbs unassigned
  neighbours with count[cur] >= 2 x count[nb] through members of the
  same cluster only (cluster.cc:58-69), a reachability closure spread by
  masked scatters, 31 sweeps for the same reason;
* a cluster is named by its seed; the final ids are the seeds' ascending
  ranks, the reference's order.

Counterpart of ``humid_tpu/cluster/directional_device.py`` (a ``jax.jit``
while loop); here a Python loop of PyTorch ops whose only host wait is
the "anything unassigned?" read at the start of each round.  Off by
default: :func:`humid_tpu_torch.pipeline.cluster_dispatch` takes it with
$HUMID_TPU_TORCH_CLUSTER=device.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device, to_device, to_host
from .exact import ClusterResult
from .labelprop import components_tensor, renumber_components

__all__ = ["cluster_directional_device"]

#: Counts double per climb jump and halve per descent step, so 31 sweeps
#: cover every count below 2^31.
_STEP_BOUND = 31

_INF = 2**31 - 1


def _any_unassigned(cluster_seed: torch.Tensor) -> bool:
    """The round loop's one host wait."""
    return bool((cluster_seed < 0).any())


def _directional_rounds(counts: torch.Tensor, comp: torch.Tensor,
                        ea: torch.Tensor, eb: torch.Tensor):
    """Every round of the per-component directional construction.

    counts [u] int64, comp [u] int64 (component = smallest node index),
    ea/eb [E] int64 undirected edges, all on one device.  Returns
    (cluster_seed [u]: the seed of each node's cluster, max_leaf_at_seed
    [u]: each cluster's maxLeaf at its seed's slot, rounds).

    Masked scatters send their dropped entries to a sentinel slot u of a
    u + 1 buffer that is cut off: a shared real index would collide with
    (and could overwrite) a valid write."""
    u = counts.shape[0]
    dev = counts.device
    node = torch.arange(u, dtype=torch.int64, device=dev)
    # Directed edges x -> y, both orientations; the count tests hold for
    # the whole call.
    ex = torch.cat([ea, eb])
    ey = torch.cat([eb, ea])
    cx, cy = counts[ex], counts[ey]
    comp_x = comp[ex]
    grow_ok = cy >= 2 * cx      # climb:   y at least doubles x
    shrink_ok = cx >= 2 * cy    # descent: x at least doubles y

    def full(value):
        return torch.full((u + 1,), value, dtype=torch.int64, device=dev)

    cluster_seed = full(-1)[:u]
    max_leaf_at_seed = full(-1)
    rounds = 0
    while _any_unassigned(cluster_seed):
        rounds += 1
        unassigned = cluster_seed < 0
        # Nothing is assigned during the climb, so its per-edge
        # unassigned gather holds for every climb sweep.
        unassigned_ey = unassigned[ey]

        # 1. The seed of each component, at the component's label slot.
        seeds = full(_INF)[:u].scatter_reduce_(
            0, comp, torch.where(unassigned, node, _INF), "amin")

        # 2. Hill-climb, every component at once: cur[c] is component c's
        # current node (INF where the component has no seed).
        cur = seeds
        for _ in range(_STEP_BOUND):
            elig = (cur[comp_x] == ex) & unassigned_ey & grow_ok
            nxt = full(_INF).scatter_reduce_(
                0, torch.where(elig, comp_x, u),
                torch.where(elig, ey, _INF), "amin")[:u]
            cur = torch.where(nxt < _INF, nxt, cur)

        # 3. The local max founds the component's cluster of this round:
        # its seed goes to the max's slot, the max (maxLeaf, cluster.cc:
        # 84-85) to the seed's slot.
        valid = seeds < _INF
        at_cur = torch.where(valid, cur, u)
        seed_buf = full(-1)
        seed_buf[:u] = cluster_seed
        cluster_seed = seed_buf.scatter_(0, at_cur, seeds)[:u]
        max_leaf_at_seed.scatter_(0, torch.where(valid, seeds, u), cur)

        # 4. Descent: spread the new clusters' seeds to unassigned
        # neighbours with count[x] >= 2 count[y], from this round's
        # members only (new_member is the frontier's source set).
        new_member = torch.zeros(u + 1, dtype=torch.bool, device=dev)
        new_member = new_member.scatter_(
            0, at_cur, torch.ones_like(at_cur, dtype=torch.bool))[:u]
        for _ in range(_STEP_BOUND):
            elig = new_member[ex] & (cluster_seed[ey] < 0) & shrink_ok
            # Components are disjoint: no two clusters compete for a node.
            upd = full(-1).scatter_reduce_(
                0, torch.where(elig, ey, u),
                torch.where(elig, cluster_seed[ex], -1), "amax")[:u]
            absorbed = (upd >= 0) & (cluster_seed < 0)
            cluster_seed = torch.where(absorbed, upd, cluster_seed)
            new_member = new_member | absorbed
    return cluster_seed, max_leaf_at_seed[:u], rounds


def cluster_directional_device(counts, pa, pb, comp=None, *, device=None,
                               info: dict | None = None) -> ClusterResult:
    """Directional clustering on ``device``; the same ClusterResult as
    ``cluster_exact(maximum=False)``, field for field.

    counts int64 [u]; (pa, pb) the sorted unique pair list; ``comp``
    optional component labels (smallest node per component), else the
    native union-find where the extension is built, else the device
    label propagation.  ``info``, if given, receives "rounds".  Counts
    past 2^30 - 1 raise ValueError: 2 x count must stay below 2^31, the
    range the 31 sweeps cover (:func:`humid_tpu_torch.pipeline.
    cluster_dispatch` sends such tables to the host walk)."""
    counts64 = np.ascontiguousarray(counts, np.int64)
    u = len(counts64)
    if u == 0:
        z = np.zeros(0, np.int64)
        return ClusterResult(z, z, z, z)
    if int(counts64.max()) > _INF // 2:
        raise ValueError("counts exceed the device formulation's int32 "
                         "doubling range")
    dev = resolve_device(device)
    pa = np.ascontiguousarray(pa, np.int64)
    pb = np.ascontiguousarray(pb, np.int64)
    if comp is None:
        try:
            from ._native import components

            comp = components(pa, pb, u)
        except ImportError:  # extension not built
            comp = components_tensor(pa, pb, u, dev)
    if not isinstance(comp, torch.Tensor):
        comp = to_device(np.ascontiguousarray(comp, np.int64), dev)
    cluster_seed, max_leaf_at_seed, rounds = _directional_rounds(
        to_device(counts64, dev), comp.to(dev), to_device(pa, dev),
        to_device(pb, dev))
    if info is not None:
        info["rounds"] = rounds
    cluster_seed, max_leaf_at_seed = to_host(cluster_seed, max_leaf_at_seed)

    # Final ids: the ascending rank of the cluster seeds.
    labels, k, seeds = renumber_components(cluster_seed)
    max_leaf = max_leaf_at_seed[seeds]
    max_count = counts64[max_leaf]
    size = np.bincount(labels - 1, weights=counts64,
                       minlength=k).astype(np.int64)
    return ClusterResult(labels, max_leaf, max_count, size)
