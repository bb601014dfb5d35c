"""A library sequenced to a depth: each read draws one of ``molecules``
uniformly, with replacement (a UMI library's molecules seen once, twice
or not at all)."""

import numpy as np


def molecules(rng: np.random.Generator, traffic: dict) -> np.ndarray:
    return rng.integers(0, int(traffic["molecules"]), int(traffic["reads"]))
