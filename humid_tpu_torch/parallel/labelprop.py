"""Connected components over the local device mesh, and the fused mesh
dedup step.

Counterpart of ``humid_tpu/parallel/labelprop.py``.  There, label
propagation runs inside ``shard_map``: each shard scatter-mins its own
edges, the shards merge their label vectors with a ``pmin`` over the
mesh axis, and two pointer jumps follow; the node-sharded variant keeps
only a node range per shard and exchanges boundary messages with an
``all_to_all``.  Here the mesh is a tuple of devices (``mesh.py``), each
shard's tensors live on its device, the ``pmin`` is an elementwise
minimum of the shards' vectors on the first shard's device, and the
``all_to_all`` is a copy of each message bucket to its receiver's device.
Every sweep is PyTorch ops; the host waits once a sweep, for the
convergence test.

The fixed point of either variant is unique: every node labelled with the
smallest node index of its component, the labels of
:func:`humid_tpu_torch.cluster.connected_components_device`.

:func:`dedup_step` is the mesh's whole device pass: the ring search (its
kernel K2, :mod:`.cuda_ring`) leaves each shard's pairs on its device,
and the replicated propagation runs over them there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cluster.labelprop import propagate
from .mesh import data_mesh, pad_to_shards

_BIG = torch.iinfo(torch.int64).max


def _replicated_components(edges, num_nodes: int, mesh) -> torch.Tensor:
    """Labels [num_nodes] int64 on ``mesh[0]``: each shard's (ea, eb)
    edges (int64, on its device; padding edges are (0, 0) self loops)
    scatter-min a replicated copy of the labels, the copies merge by an
    elementwise minimum (the reference's ``pmin``), then two pointer
    jumps, until a sweep changes nothing."""
    dev0 = mesh[0]

    def sweep(labels):
        merged = None
        for (ea, eb), dev in zip(edges, mesh):
            lab = labels.to(dev)
            m = torch.minimum(lab[ea], lab[eb])
            lab = lab.scatter_reduce(0, ea, m, "amin")
            lab = lab.scatter_reduce(0, eb, m, "amin").to(dev0)
            merged = lab if merged is None else torch.minimum(merged, lab)
        merged = merged[merged]
        return merged[merged]

    return propagate(sweep, torch.arange(num_nodes, dtype=torch.int64,
                                         device=dev0))


def distributed_components(a: np.ndarray, b: np.ndarray, num_nodes: int, *,
                           mesh=None, node_sharded: bool = False,
                           device=None) -> np.ndarray:
    """Component labels (the smallest node index of each component, int64)
    of an undirected edge list whose edges are sharded over ``mesh``
    (default ``data_mesh(device=device)``).

    Every shard holds a replicated copy of the labels, 8 bytes a node,
    and pointer jumping converges in few sweeps.  ``node_sharded=True``
    runs :func:`distributed_components_node_sharded` instead (each shard
    holds the labels of a node range only), for a label vector too large
    for one shard's device.  The reference switches to it from 2^16
    nodes; on the card it was the slower of the two at every size
    measured (PERF.md), so here the caller asks for it."""
    mesh = mesh or data_mesh(device=device)
    d = len(mesh)
    if num_nodes == 0:
        return np.zeros(0, np.int64)
    if node_sharded:
        return distributed_components_node_sharded(a, b, num_nodes,
                                                   mesh=mesh)
    if len(a) == 0:
        return np.arange(num_nodes, dtype=np.int64)
    edges = pad_to_shards(np.stack([np.asarray(a, np.int64),
                                    np.asarray(b, np.int64)], axis=1),
                          d, multiple=8, fill=0)
    per = len(edges) // d
    shards = []
    for s, dev in enumerate(mesh):
        e = torch.from_numpy(np.ascontiguousarray(
            edges[s * per:(s + 1) * per].T)).to(dev)
        shards.append((e[0], e[1]))
    return _replicated_components(shards, num_nodes, mesh).cpu().numpy()


def node_shard_inputs(a, b, num_nodes: int, d: int):
    """Host prep of the node-sharded propagation (the reference's, as it
    is): nodes split into d contiguous ranges of ``us`` rows; intra-shard
    edges in local indices, padded with ``us`` (a sentinel slot); every
    cross edge becomes two directed boundary messages, bucketed by
    (source shard, destination shard) in one order on both sides, so
    sender slot j and receiver slot j describe the same message.

    Returns (us, ea [d, el], eb [d, el], msg_src [d, d, k] (sender,
    receiver, slot: the source's local index, -1 padding), recv_dst
    [d, d, k] (receiver, sender, slot: the target's local index, us
    padding)), int32."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    us = -(-num_nodes // d)
    us = max(8, -(-us // 8) * 8)
    own_a, own_b = a // us, b // us
    la, lb = (a % us).astype(np.int32), (b % us).astype(np.int32)
    intra = own_a == own_b
    ea_s = [la[intra & (own_a == s)] for s in range(d)]
    eb_s = [lb[intra & (own_a == s)] for s in range(d)]
    el = max(8, 1 << int(max(1, max(len(x) for x in ea_s)) - 1)
             .bit_length())
    ea_pad = np.full((d, el), us, np.int32)
    eb_pad = np.full((d, el), us, np.int32)
    for s in range(d):
        ea_pad[s, :len(ea_s[s])] = ea_s[s]
        eb_pad[s, :len(eb_s[s])] = eb_s[s]
    cross = ~intra
    srcs = np.concatenate([own_a[cross], own_b[cross]])
    dsts = np.concatenate([own_b[cross], own_a[cross]])
    sloc = np.concatenate([la[cross], lb[cross]]).astype(np.int32)
    dloc = np.concatenate([lb[cross], la[cross]]).astype(np.int32)
    order = np.lexsort((dloc, sloc, dsts, srcs))
    srcs, dsts, sloc, dloc = (srcs[order], dsts[order], sloc[order],
                              dloc[order])
    counts = np.zeros((d, d), np.int64)
    np.add.at(counts, (srcs, dsts), 1)
    k = max(1, 1 << int(max(1, counts.max()) - 1).bit_length())
    msg_src = np.full((d, d, k), -1, np.int32)
    recv_dst = np.full((d, d, k), us, np.int32)
    if len(srcs):
        # Slot of each message within its (src, dst) bucket: position
        # minus bucket start (messages are bucket-sorted).
        key = srcs * d + dsts
        pos = np.arange(len(key))
        new = np.empty(len(key), bool)
        new[0] = True
        np.not_equal(key[1:], key[:-1], out=new[1:])
        j = pos - np.maximum.accumulate(np.where(new, pos, 0))
        msg_src[srcs, dsts, j] = sloc
        recv_dst[dsts, srcs, j] = dloc
    return us, ea_pad, eb_pad, msg_src, recv_dst


def distributed_components_node_sharded(a: np.ndarray, b: np.ndarray,
                                        num_nodes: int, *, mesh=None,
                                        device=None) -> np.ndarray:
    """Component labels with the label vector sharded over node ranges:
    each shard's device holds O(U/D) labels (the replicated variant keeps
    a whole copy per shard).  A sweep scatter-mins each shard's intra
    edges, then sends each boundary bucket's source labels to the bucket's
    receiver, which scatter-mins them into its targets (the reference's
    ``all_to_all``); no pointer jumping (a label may live on another
    shard), so it converges in O(component diameter) sweeps.  int64."""
    mesh = mesh or data_mesh(device=device)
    d = len(mesh)
    if num_nodes == 0:
        return np.zeros(0, np.int64)
    us, ea, eb, msg_src, recv_dst = node_shard_inputs(a, b, num_nodes, d)
    up = lambda x, dev: torch.from_numpy(
        np.ascontiguousarray(x, np.int64)).to(dev)
    ea = [up(ea[s], dev) for s, dev in enumerate(mesh)]
    eb = [up(eb[s], dev) for s, dev in enumerate(mesh)]
    src = [up(msg_src[s], dev) for s, dev in enumerate(mesh)]  # [d, k]
    dst = [up(recv_dst[r], dev).flatten() for r, dev in enumerate(mesh)]
    labels = []
    for s, dev in enumerate(mesh):
        lab = torch.arange(s * us, (s + 1) * us + 1, dtype=torch.int64,
                           device=dev)
        lab[us] = _BIG
        labels.append(lab)

    def sweep(labels):
        out = []
        for s in range(d):
            lab = labels[s]
            m = torch.minimum(lab[ea[s]], lab[eb[s]])
            lab = lab.scatter_reduce(0, ea[s], m, "amin")
            out.append(lab.scatter_reduce(0, eb[s], m, "amin"))
        if d > 1:
            vals = [torch.where(src[s] >= 0, out[s][src[s].clamp(min=0)],
                                _BIG) for s in range(d)]
            for r, dev in enumerate(mesh):
                recv = torch.stack([vals[s][r].to(dev) for s in range(d)])
                out[r] = out[r].scatter_reduce(0, dst[r], recv.flatten(),
                                               "amin")
        for lab in out:
            lab[us] = _BIG
        return out

    prev, labels = labels, sweep(labels)
    while _changed(prev, labels, mesh[0]):
        prev, labels = labels, sweep(labels)
    full = torch.cat([lab[:us].to(mesh[0]) for lab in labels])
    return full[:num_nodes].cpu().numpy()


def _changed(prev, labels, dev0) -> bool:
    """Whether any shard's labels changed (one host wait)."""
    flags = torch.stack([(p != q).any().to(dev0)
                         for p, q in zip(prev, labels)])
    return bool(flags.any())


def dedup_step(packed: np.ndarray, max_dist: int, *, mesh=None, device=None,
               block_cap: int | None = None):
    """The mesh's whole device pass: unique fingerprints -> component
    labels, the membership of the reference's maximum clustering flood
    fill (cluster.cc:72-80) on the same graph.

    The ring search (kernel K2) leaves each shard's pairs on its device;
    the replicated propagation runs over them there.  Returns (labels [U]
    int64, the smallest word index of each component; pairs [D] int64,
    the pairs each shard's ring emitted).  The reference returns per-tile
    match counts in the second slot; the CUDA ring counts per shard, and
    the two sum to the same number of pairs."""
    mesh = mesh or data_mesh(device=device)
    u = len(packed)
    counts = np.zeros(len(mesh), np.int64)
    if u <= 1 or max_dist == 0:
        return np.arange(u, dtype=np.int64), counts
    from .cuda_ring import ring_shard_keys

    keys = ring_shard_keys(packed, max_dist, mesh=mesh, block_cap=block_cap)
    counts[:] = [len(k) for k in keys]
    edges = [(k // u, k % u) for k in keys]
    return _replicated_components(edges, u, mesh).cpu().numpy(), counts
