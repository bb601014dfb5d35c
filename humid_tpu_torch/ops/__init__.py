from .unique import unique_words, unique_words_device
from .neighbors import find_neighbor_pairs, pairs_to_csr

__all__ = ["unique_words", "unique_words_device", "find_neighbor_pairs",
           "pairs_to_csr"]
