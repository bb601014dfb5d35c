"""PCR duplicates of distinct fragments: ``reads * (1 - duplicate_share)``
fragments are read once each, and the other reads are duplicates, each of
a fragment drawn uniformly from them.  Reads are in a random order."""

import numpy as np


def molecules(rng: np.random.Generator, traffic: dict) -> np.ndarray:
    reads = int(traffic["reads"])
    n_dup = int(round(reads * float(traffic["duplicate_share"])))
    n_frag = reads - n_dup
    mol = np.concatenate([np.arange(n_frag, dtype=np.int64),
                          rng.integers(0, n_frag, n_dup)])
    return mol[rng.permutation(reads)]
