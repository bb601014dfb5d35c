from .exact import cluster_exact, cluster_max_from_components, ClusterResult
from .labelprop import connected_components_device, renumber_components

__all__ = ["cluster_exact", "cluster_max_from_components", "ClusterResult",
           "connected_components_device", "renumber_components"]
