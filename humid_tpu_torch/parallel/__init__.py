"""Work over several shards: the local device mesh (one process, several
shards: the ring-rotated block compare and the pigeonhole-bucketed mesh
search, for edit distance the dense edit ring and the shifted mesh
search; connected components and the mesh dedup step) and several
processes (:mod:`.multihost`, :mod:`.pipeline`, :mod:`.cluster`:
host-sharded neighbour search and clustering over ``torch.distributed``).
Counterpart of ``humid_tpu/parallel``."""

from .cuda_ring import (RingLimitExceeded, ring_fits, ring_schedule,
                        sharded_neighbor_pairs_ring)
from .labelprop import (dedup_step, distributed_components,
                        distributed_components_node_sharded)
from .mesh import data_mesh, pad_to_shards
from .neighbors import (sharded_edit_pairs_shifted, sharded_neighbor_pairs,
                        sharded_neighbor_pairs_bucketed)
from .pipeline import run_distributed, run_sharded

#: The reference's name for the ring route (K2 is its port).
sharded_neighbor_pairs_pallas_ring = sharded_neighbor_pairs_ring

__all__ = ["RingLimitExceeded", "data_mesh", "dedup_step",
           "distributed_components", "distributed_components_node_sharded",
           "pad_to_shards", "ring_fits", "ring_schedule", "run_distributed",
           "run_sharded", "sharded_edit_pairs_shifted",
           "sharded_neighbor_pairs", "sharded_neighbor_pairs_bucketed",
           "sharded_neighbor_pairs_pallas_ring",
           "sharded_neighbor_pairs_ring"]
