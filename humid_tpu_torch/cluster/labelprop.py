"""Device connected components by iterative min-label propagation.

Replaces the reference's recursive flood fill (``assignMaxCluster``,
cluster.cc:72-80) for ``-x``: component membership is the same, computed
as a data-parallel fixed point instead of a pointer chase.  Every node
starts labelled with its own index; a sweep scatter-mins each edge
endpoint with the other endpoint's label and then jumps pointers twice
(label <- label[label]), so a handful of sweeps converge.

Counterpart of ``humid_tpu/cluster/labelprop.py``, whose ``_labelprop`` is
a ``jax.jit`` while loop; here a Python loop of PyTorch ops with one
device comparison per sweep.  Cluster ids are renumbered 1..K by
ascending component minimum: the reference's seed order (first
unassigned leaf in lexicographic walk order, humid.cc:177-180).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device


def propagate(sweep, labels: torch.Tensor) -> torch.Tensor:
    """Apply ``sweep`` from ``labels`` until a sweep changes nothing (one
    device comparison, a host wait, per sweep)."""
    prev, labels = labels, sweep(labels)
    while not torch.equal(labels, prev):
        prev, labels = labels, sweep(labels)
    return labels


def _edge_sweep(a: torch.Tensor, b: torch.Tensor):
    def sweep(labels):
        m = torch.minimum(labels[a], labels[b])
        labels = labels.scatter_reduce(0, a, m, "amin")
        labels = labels.scatter_reduce(0, b, m, "amin")
        labels = labels[labels]
        return labels[labels]
    return sweep


def components_tensor(a: np.ndarray, b: np.ndarray, num_nodes: int,
                      device=None) -> torch.Tensor:
    """:func:`connected_components_device`'s labels as an int64 tensor
    left on ``device``."""
    dev = resolve_device(device)
    init = torch.arange(num_nodes, dtype=torch.int64, device=dev)
    if num_nodes == 0 or len(a) == 0:
        return init
    ea = torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)
    eb = torch.from_numpy(np.ascontiguousarray(b, np.int64)).to(dev)
    return propagate(_edge_sweep(ea, eb), init)


def connected_components_device(a: np.ndarray, b: np.ndarray,
                                num_nodes: int, device=None) -> np.ndarray:
    """Component labels (the smallest node index in each component) of an
    undirected edge list, on ``device``; int64 numpy.  Self edges (i, i)
    are harmless."""
    if num_nodes == 0:
        return np.zeros(0, np.int64)
    if len(a) == 0:
        return np.arange(num_nodes, dtype=np.int64)
    return components_tensor(a, b, num_nodes, device).cpu().numpy()


def renumber_components(labels: np.ndarray) -> tuple[np.ndarray, int,
                                                     np.ndarray]:
    """Component labels (minimum index) -> 1-based cluster ids in
    ascending label order, the reference's seed order.  Returns (ids [U]
    int64, number of clusters, seeds: the sorted distinct labels, each
    component's smallest node index)."""
    uniq, inv = np.unique(labels, return_inverse=True)
    return (inv + 1).astype(np.int64), len(uniq), uniq.astype(np.int64)
