"""Neighbour search over a local device mesh (one process, several
shards): the ring-rotated block compare and the pigeonhole-bucketed mesh
search, and for edit distance the dense edit ring and the shifted mesh
search.  Counterpart of ``humid_tpu/parallel``."""

from .cuda_ring import (RingLimitExceeded, ring_fits, ring_schedule,
                        sharded_neighbor_pairs_ring)
from .mesh import data_mesh, pad_to_shards
from .neighbors import (sharded_edit_pairs_shifted, sharded_neighbor_pairs,
                        sharded_neighbor_pairs_bucketed)

__all__ = ["RingLimitExceeded", "data_mesh", "pad_to_shards", "ring_fits",
           "ring_schedule", "sharded_edit_pairs_shifted",
           "sharded_neighbor_pairs",
           "sharded_neighbor_pairs_bucketed", "sharded_neighbor_pairs_ring"]
