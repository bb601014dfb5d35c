"""Profile the ring on the card: do the slot copies overlap the kernels?

    python -m humid_tpu_torch.tools.ring_profile [--reads N] [--shards D]
                                                 [--trace FILE]

Builds the unique table of an N-read sample (pool of N/8 random 24-base
words plus one-substitution copies: ``sample_table``, which
chip_smoke.py uses for its tables too), runs
``sharded_neighbor_pairs_ring`` on D shards once to warm up, then once
under ``torch.profiler``, and prints one JSON line: the card, the device
time of the ring kernels and of the slot copies between shards (the
device memcpys of exactly one slot's size that do not come from the host), how much
of the copy time lies inside a kernel's interval (from the trace's own
timestamps), and the span from the first to the last of those events.
``--trace`` also keeps the Chrome trace.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile

import numpy as np
import torch

from .. import words as W
from ..ops import unique_words
from ..parallel import data_mesh, sharded_neighbor_pairs_ring


def sample_table(n_reads: int, length: int = 24, seed: int = 0,
                 n_subst: int = 1):
    """Unique word table of an ``n_reads`` sample: the pool words plus one
    copy with ``n_subst`` substitutions per read whose mutation falls
    inside the word."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 4, size=(n_reads // 8, length), dtype=np.uint8)
    n_mut = int(n_reads * 0.3 * length / 100)
    mut = pool[rng.integers(0, len(pool), n_mut)].copy()
    for _ in range(n_subst):
        mut[np.arange(n_mut), rng.integers(0, length, n_mut)] = rng.integers(
            0, 4, n_mut, dtype=np.uint8)
    return unique_words(W.pack_words(np.concatenate([pool, mut])),
                        want_inverse=False)[0]


def _overlap_us(spans, others) -> float:
    """Total time of ``spans`` that lies inside the union of ``others``
    (lists of (start, end))."""
    merged: list[list[float]] = []
    for lo, hi in sorted(others):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return sum(max(0.0, min(hi, mhi) - max(lo, mlo))
               for lo, hi in spans for mlo, mhi in merged)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ring_profile needs a CUDA card")
    uniq = sample_table(args.reads)
    mesh = data_mesh(args.shards, "cuda")
    run = lambda: sharded_neighbor_pairs_ring(uniq, 1, word_length=24,
                                              mesh=mesh)
    pairs = run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    path = args.trace or os.path.join(tempfile.mkdtemp(), "ring.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy")]
    span = lambda e: (e["ts"], e["ts"] + e["dur"])
    kernels = [span(e) for e in dev if "ring_sweep_kernel" in e["name"]]
    slot_bytes = -(-len(uniq) // args.shards) * uniq.shape[1] * 4
    copies = [span(e) for e in dev if e["cat"] == "gpu_memcpy"
              and e.get("args", {}).get("bytes") == slot_bytes
              and "htod" not in e["name"].lower().replace(" ", "")]
    if not kernels:
        raise SystemExit("the trace holds no ring kernel: no device time "
                         "was recorded")
    both = kernels + copies
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({
        "card": card.stdout.strip().splitlines(),
        "cards_in_mesh": len({str(d) for d in mesh}),
        "uniques": len(uniq), "shards": args.shards, "pairs": len(pairs[0]),
        "ring_kernels": len(kernels),
        "ring_kernel_us": sum(hi - lo for lo, hi in kernels),
        "slot_bytes": slot_bytes, "slot_copies": len(copies),
        "slot_copy_us": sum(hi - lo for lo, hi in copies),
        "slot_copy_us_inside_a_kernel": _overlap_us(copies, kernels),
        "kernel_us_inside_another_kernel": sum(
            _overlap_us([k], kernels[:i] + kernels[i + 1:])
            for i, k in enumerate(kernels)) / 2,
        "first_to_last_event_us": max(hi for _, hi in both)
        - min(lo for lo, _ in both)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
