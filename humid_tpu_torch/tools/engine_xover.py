"""The neighbour engines against each other from 2^18 to 2^23 uniques.

    python -m humid_tpu_torch.tools.engine_xover
        [--sizes 262144 1048576 4194304 8388608] [--word-length 24] [--m 1]
        [--runs 3] [--engines runs,bucketed,dense,runs_device,
        phasewise_device,fused] [--device D]

Counterpart of the JAX package's ``scripts/engine_xover.py``.  At each
size :func:`gen_uniques` (the reference's generator: a pool of u·3/8
words of ``--word-length`` bases, 3u reads drawn from it, 30% with one
substitution, unique and sorted, then a sorted uniform subsample of u)
gives the table, and each engine runs ``--runs`` times; one JSON line per
(size, engine) with the reference's keys (``u``, ``engine``, ``backend``,
``best_s``, ``pairs``, ``ns_per_unique``) plus ``card`` (nvidia-smi's
name and power limit; null off a card).

* Table engines, on the table (``find_neighbor_pairs`` strategies):
  host ``runs``, ``bucketed`` and ``dense`` (both the K1 tile sweep on a
  card) and ``runs_device``.
* Whole-pipeline engines, on all 3u packed reads (their table is every
  unique word of the reads, so ``u`` is larger; ``n_reads`` and
  ``ns_per_read`` added): ``fused`` (``ops.fused.fused_probe``) and
  ``phasewise_device`` (``unique_words_device`` then
  ``runs_device_pairs``).

Every engine's pairs must agree: the table engines' arrays are equal, the
whole-pipeline engines' are equal, and theirs restricted to the
subsample's words equal the table engines' (``table_pairs`` is that
count).  A difference raises.  One more line per size gives the
generator's seconds on its own.  Timings are host wall clocks around
calls that return host arrays, so each ends after the card's work.

There is no ``_probe_backend`` (the port's device is attached, not
tunnelled) and no ``impl`` choice (the port has one kernel a sweep).
The device is ``resolve_device()``'s: CUDA unless ``--device cpu`` or
HUMID_TPU_TORCH_DEVICE=cpu; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .. import words as W
from .._device import resolve_device
from ..ops.neighbors import find_neighbor_pairs
from ..ops.unique import unique_words
from .bench import card_line

TABLE_ENGINES = ("runs", "bucketed", "dense", "runs_device")
WHOLE_ENGINES = ("phasewise_device", "fused")
DEFAULT_SIZES = (1 << 18, 1 << 20, 1 << 22, 1 << 23)


def _draw(u: int, word_length: int, dup: int, seed: int):
    """The reads and their unique table, and the generator where the
    subsample draws from it."""
    rng = np.random.default_rng(seed)
    # n = 2u yields only ~0.69u uniques; oversample ~1.5x then subsample.
    n = u * 3
    pool = rng.integers(0, 4, size=(n // dup, word_length)).astype(np.uint8)
    codes = pool[rng.integers(0, len(pool), n)].copy()
    mut = rng.random(n) < 0.3
    n_mut = int(mut.sum())
    codes[np.flatnonzero(mut), rng.integers(0, word_length, n_mut)] = (
        rng.integers(0, 4, n_mut))
    packed = W.pack_words(codes)
    uniq, _, _, _ = unique_words(packed, want_inverse=False, device="cpu")
    return rng, uniq, packed


def _keep(rng, n_uniq: int, u: int):
    """Sorted indices of the uniform subsample of u of n_uniq uniques (None
    when all are kept)."""
    if n_uniq <= u:
        return None
    return np.sort(rng.choice(n_uniq, u, replace=False))


def gen_uniques(u: int, word_length: int = 24, dup: int = 8,
                seed: int = 0, return_reads: bool = False):
    """Unique packed words shaped like the bench pipeline's (the
    reference's ``gen_uniques``, array for array): ``u`` sorted uniques
    of a pool of 3u/dup words read 3u times, 30% with one substitution.
    ``return_reads`` returns (all uniques of the reads, the 3u packed
    reads) instead: the input of the whole-pipeline engines."""
    rng, uniq, packed = _draw(u, word_length, dup, seed)
    if return_reads:
        return uniq, packed
    keep = _keep(rng, len(uniq), u)
    return uniq if keep is None else uniq[keep]


def restrict(pairs, keep, n_uniq: int):
    """Pairs over all n_uniq uniques -> the pairs between words of the
    subsample ``keep`` (sorted indices), renumbered into it; the order
    (a, b) is kept."""
    a, b = pairs
    if keep is None:
        return a, b
    pos = np.full(n_uniq, -1, np.int64)
    pos[keep] = np.arange(len(keep))
    a, b = pos[a], pos[b]
    sel = (a >= 0) & (b >= 0)
    return a[sel], b[sel]


def _best(fn, runs: int):
    best, out = None, None
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best, out


def _same(name: str, got, want) -> None:
    if not (np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1])):
        raise AssertionError(f"{name}: {len(got[0])} pairs differ from the "
                             f"reference engine's {len(want[0])}")


def measure(u_req: int, engines, *, word_length: int = 24, m: int = 1,
            runs: int = 3, device=None, card: str | None = None):
    """Every engine of ``engines`` at ``u_req`` uniques: (generator line,
    one line per engine, {engine: pairs}); the pairs of all engines are
    checked against each other (module docstring)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    rng, full, reads = _draw(u_req, word_length, 8, 0)
    keep = _keep(rng, len(full), u_req)
    table = full if keep is None else full[keep]
    gen = {"u": len(table), "uniques_of_reads": len(full),
           "n_reads": len(reads), "generator_s": time.perf_counter() - t0}
    lines, pairs = [], {}
    for eng in (e for e in engines if e in TABLE_ENGINES):
        best, pairs[eng] = _best(lambda: find_neighbor_pairs(
            table, m, strategy=eng, word_length=word_length, device=dev),
            runs)
        lines.append({"u": len(table), "engine": eng, "backend": dev.type,
                      "best_s": best, "pairs": len(pairs[eng][0]),
                      "ns_per_unique": best / len(table) * 1e9,
                      "card": card})

    def phasewise():
        from ..ops.runs_device import runs_device_pairs
        from ..ops.unique import unique_words_device

        uq, _, _, _ = unique_words_device(reads, want_inverse=False,
                                          device=dev)
        return len(uq), runs_device_pairs(uq, m, word_length=word_length,
                                          device=dev)

    def fused():
        from ..ops.fused import fused_probe

        k, _, _, pr = fused_probe(reads, word_length, m, device=dev)
        return k, pr

    for eng, fn in (("phasewise_device", phasewise), ("fused", fused)):
        if eng not in engines:
            continue
        best, (uu, pairs[eng]) = _best(fn, runs)
        if uu != len(full):
            raise AssertionError(f"{eng}: {uu} uniques, the host's "
                                 f"unique_words {len(full)}")
        lines.append({"u": uu, "n_reads": len(reads), "engine": eng,
                      "backend": dev.type, "best_s": best,
                      "pairs": len(pairs[eng][0]),
                      "table_pairs": len(restrict(pairs[eng], keep,
                                                  len(full))[0]),
                      "ns_per_unique": best / uu * 1e9,
                      "ns_per_read": best / len(reads) * 1e9, "card": card})
    table_names = [e for e in engines if e in TABLE_ENGINES]
    whole_names = [e for e in engines if e in WHOLE_ENGINES]
    for e in table_names[1:]:
        _same(f"{u_req} {e} vs {table_names[0]}", pairs[e],
              pairs[table_names[0]])
    for e in whole_names[1:]:
        _same(f"{u_req} {e} vs {whole_names[0]}", pairs[e],
              pairs[whole_names[0]])
    if table_names and whole_names:
        _same(f"{u_req} {whole_names[0]} on the table vs {table_names[0]}",
              restrict(pairs[whole_names[0]], keep, len(full)),
              pairs[table_names[0]])
    return gen, lines, pairs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sizes", type=int, nargs="+", default=list(DEFAULT_SIZES))
    p.add_argument("--word-length", type=int, default=24)
    p.add_argument("--m", type=int, default=1)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--engines", default=",".join(TABLE_ENGINES
                                                 + WHOLE_ENGINES))
    p.add_argument("--device", default=None,
                   help="cuda (default, or $HUMID_TPU_TORCH_DEVICE) or cpu")
    args = p.parse_args(argv)
    engines = args.engines.split(",")
    unknown = set(engines) - set(TABLE_ENGINES + WHOLE_ENGINES)
    if unknown:
        p.error(f"unknown engines {sorted(unknown)}")
    dev = resolve_device(args.device)
    card = card_line(dev)
    for u in args.sizes:
        gen, lines, _ = measure(u, engines, word_length=args.word_length,
                                m=args.m, runs=args.runs, device=dev,
                                card=card)
        print(json.dumps(gen), flush=True)
        for line in lines:
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
