"""PCR duplicates of distinct fragments, read on a platform whose errors
are mostly insertions and deletions.

Molecules are drawn as ``duplicate_share`` draws them: ``reads * (1 -
duplicate_share)`` fragments read once each, the other reads duplicates
of fragments drawn uniformly, in a random order.  Each fragment is
``read_length + 16`` random bases.  A read copies its fragment; then
every base of the copy is deleted with probability ``indel_rate / 2``,
has a random base inserted before it with probability ``indel_rate / 2``,
and is substituted by another base with probability
``substitution_rate``.  The read is the first ``read_length`` bases of
the result, so a deletion pulls in the fragment's next real base; a read
that comes out shorter is padded with random bases at its end.

Single-file layouts without a UMI only (a word of the read's first
bases).  Vectorised NumPy, deterministic from the seed; it imports numpy
only, as it runs in the generator's child process.
"""

import os
import sys

import numpy as np

_BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _BENCH not in sys.path:
    sys.path.insert(0, _BENCH)

from pbench import generate as G  # noqa: E402

#: Bases a fragment holds beyond the read: what deletions pull in.
SPARE = 16
#: Reads mutated at a time (some tens of MB of scratch each).
CHUNK = 1 << 16


def _hits(rng: np.random.Generator, size: int, rate: float) -> np.ndarray:
    """Flat positions, among ``size``, that an event of probability
    ``rate`` a position falls on (a position drawn twice counts once)."""
    return np.unique(rng.integers(0, size, int(rng.binomial(size, rate))))


def mutate(rng: np.random.Generator, frags: np.ndarray, read_length: int,
           indel_rate: float, substitution_rate: float) -> np.ndarray:
    """[n, read_length] uint8 reads of ``frags`` ([n, >= read_length] base
    codes, left as they are) with the module's errors applied."""
    n, length = frags.shape
    flat = frags.reshape(-1).copy()
    sub = _hits(rng, flat.size, substitution_rate)
    flat[sub] = (flat[sub] + rng.integers(1, 4, len(sub)).astype(np.uint8)) & 3
    dels = _hits(rng, flat.size, indel_rate / 2)
    ins = _hits(rng, flat.size, indel_rate / 2)
    kept = np.ones(flat.size, bool)
    kept[dels] = False
    # Every read's bases end to end: base j sits at j less the deletions
    # before it, and a base inserted before j goes in there (before j's
    # successor where j itself was deleted).
    seq = np.insert(flat[kept], ins - np.searchsorted(dels, ins),
                    rng.integers(0, 4, len(ins)).astype(np.uint8))
    per_read = (length - np.bincount(dels // length, minlength=n)
                + np.bincount(ins // length, minlength=n))
    start = np.cumsum(per_read) - per_read
    at = start[:, None] + np.arange(read_length)
    short = at >= (start + per_read)[:, None]
    got = seq[np.minimum(at, seq.size - 1)]
    pad = G.random_codes(rng, n, read_length)
    return np.where(short, pad, got)


def generate(config: dict, traffic: dict, seed: int, out_dir: str) -> dict:
    layout = config["layout"]
    if int(layout["files"]) != 1 or int(layout["umi_length"]):
        raise ValueError("indel_share writes one file of reads without a UMI")
    read_len = int(layout["read_length"])
    rng = np.random.default_rng(seed)
    mol = G.generator({"generator": "duplicate_share"}).molecules(rng, traffic)
    seen, inverse = np.unique(mol, return_inverse=True)
    frags = G.random_codes(rng, len(seen), read_len + SPARE)
    reads = np.empty((len(mol), read_len), np.uint8)
    for lo in range(0, len(mol), CHUNK):
        hi = min(lo + CHUNK, len(mol))
        reads[lo:hi] = mutate(rng, frags[inverse[lo:hi]], read_len,
                              float(traffic["indel_rate"]),
                              float(traffic["substitution_rate"]))
    path = os.path.join(out_dir, "r1.fastq")
    G.write_fastq(path, reads, None)
    return {"files": [path], "reads": int(len(mol))}
