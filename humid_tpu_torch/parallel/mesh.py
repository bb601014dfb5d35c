"""Local device mesh of the sharded neighbour search.

Counterpart of ``humid_tpu/parallel/mesh.py``.  The JAX mesh is one
process driving several devices, and so is this one: a mesh is a tuple of
``torch.device``, one entry per shard.  More shards than cards are placed
round-robin on the cards there are, so the d-shard schedules also run on
one card and on the CPU (where the JAX package's tests force eight
virtual host devices instead).  The ``NamedSharding`` helpers of the
reference have no counterpart: each shard's tensors are simply created on
its device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .._device import resolve_device

SHARDS_ENV_VAR = "HUMID_TPU_TORCH_SHARDS"


def data_mesh(n_shards: int | None = None,
              device: str | torch.device | None = None) -> tuple:
    """A 1-D mesh of ``n_shards`` shards on ``device`` (resolved by
    ``_device.resolve_device``).

    ``n_shards`` defaults to $HUMID_TPU_TORCH_SHARDS if set, else to the
    number of CUDA cards (1 on the CPU).  A CUDA device without an index
    spreads the shards round-robin over all cards; one with an index
    (``cuda:1``) keeps every shard on that card."""
    dev = resolve_device(device)
    if n_shards is None:
        env = os.environ.get(SHARDS_ENV_VAR)
        if env:
            n_shards = int(env)
        else:
            n_shards = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
    if dev.type != "cuda" or dev.index is not None:
        return (dev,) * n_shards
    cards = torch.cuda.device_count()
    return tuple(torch.device("cuda", i % cards) for i in range(n_shards))


def pad_to_shards(x: np.ndarray, n_shards: int, multiple: int = 8,
                  fill=0) -> np.ndarray:
    """Pad the leading axis so it divides evenly into ``n_shards`` blocks
    whose size is a multiple of ``multiple``."""
    n = x.shape[0]
    per = -(-n // n_shards)
    per = -(-per // multiple) * multiple
    total = per * n_shards
    if total == n:
        return x
    pad_shape = (total - n,) + x.shape[1:]
    return np.concatenate([x, np.full(pad_shape, fill, dtype=x.dtype)])
