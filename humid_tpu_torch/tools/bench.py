"""End-to-end dedup throughput of the port: the counterpart of the JAX
package's ``bench.py``.

    python -m humid_tpu_torch.tools.bench [--reads N] [--distance D]
                                          [--no-warmup] [--runs R]

Measures reads/s of ``humid_tpu_torch.run`` on a synthetic dataset (one
single-end FastQ of N 100-base reads drawn from a pool of N/8 sequences,
30% of them with one substitution; byte-identical to ``bench.py``'s for the
same arguments) with ``bench.py``'s flags: distance D, dedup output only,
no statistics, no annotated output, the default word length.  After one
untimed warm-up run (kernel builds, the router's calibration, CUDA start),
it samples runs until the best has stopped improving (``sampling_done``;
``--runs R`` takes exactly R runs instead: the memory curve of a long
process),
times ``baseline/humid_ref`` (single-core C++, the reference's semantics)
twice on the same file with the same flags, and prints ONE JSON line:
``bench.py``'s keys in its order, then ``baseline_source`` ("humid_ref",
or "estimate" when humid_ref could not be built or run and the
reference's ~40k reads/s estimate stands in), ``card`` (nvidia-smi's
name and power limit; null on the CPU) and ``host_extensions`` (which of
the port's host C extensions imported).  ``tunnel_factor`` is always null:
the port has no tunnelled device to probe.

The device is ``resolve_device()``'s: CUDA unless HUMID_TPU_TORCH_DEVICE
says ``cpu``; without CUDA the bench raises rather than measure the CPU.
The dataset is cached in ``$TMPDIR/humid_tpu_torch_bench`` (default
``/tmp``), where the runs write ``out/`` and humid_ref writes ``out_ref/``:
the two dedup files must be byte-identical (``chip_smoke.py`` checks).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .. import _backend
from .._device import resolve_device
from ..pipeline import run

#: reads/s of the reference's own troubleshooting log (22m42s + 17m10s for a
#: WGS-scale run), used only when humid_ref cannot be built or run.
BASELINE_READS_PER_SEC = 40_000.0
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HUMID_REF = os.path.join(REPO, "baseline", "humid_ref")
HUMID_REF_SRC = os.path.join(REPO, "baseline", "humid_ref.cpp")
EXTENSIONS = ("_hostops", "_ccluster", "_cfastqio")


def gen_dataset(path: str, n_reads: int, read_len: int = 100,
                dup_factor: int = 8, seed: int = 0) -> None:
    """Synthetic single-end FastQ: ``n_reads`` reads drawn from a pool of
    n_reads/dup_factor distinct sequences, each with a 30% chance of one
    random substitution (near-duplicates for the distance-1 search)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pool = bases[rng.integers(0, 4, size=(n_reads // dup_factor, read_len))]
    idx = rng.integers(0, len(pool), n_reads)
    seqs = pool[idx].copy()
    mut = rng.random(n_reads) < 0.3
    pos = rng.integers(0, read_len, n_reads)
    seqs[np.flatnonzero(mut), pos[mut]] = bases[
        rng.integers(0, 4, int(mut.sum()))
    ]
    write_fastq(path, seqs)


def write_fastq(path: str, seqs: np.ndarray) -> None:
    """[n, read_len] uint8 base characters -> FastQ records named
    @read000000000, @read000000001, ..., every quality 'I'."""
    n_reads, read_len = seqs.shape
    with open(path, "wb") as f:
        chunk = 1 << 18
        for lo in range(0, n_reads, chunk):
            hi = min(lo + chunk, n_reads)
            k = hi - lo
            # Fixed-width names "@read<9 digits>": fully vectorized.
            ids = np.arange(lo, hi, dtype=np.int64)
            digits = np.empty((k, 9), np.uint8)
            v = ids
            for p in range(8, -1, -1):
                digits[:, p] = (v % 10) + ord("0")
                v = v // 10
            nlen = 5 + 9  # "@read" + 9 digits
            rec_len = nlen + 1 + read_len + 3 + read_len + 1
            rec = np.full((k, rec_len), ord("I"), np.uint8)
            rec[:, 0:5] = np.frombuffer(b"@read", np.uint8)
            rec[:, 5:14] = digits
            rec[:, 14] = 10
            rec[:, 15:15 + read_len] = seqs[lo:hi]
            rec[:, 15 + read_len] = 10
            rec[:, 16 + read_len] = ord("+")
            rec[:, 17 + read_len] = 10
            rec[:, rec_len - 1] = 10
            f.write(rec.tobytes())


def run_once(files, out_dir: str, device: torch.device, **kw):
    """Seconds of one ``run()`` (on a card, to the end of its device work)
    and its result."""
    t0 = time.perf_counter()
    res = run(files, dir_name=out_dir, log_name=os.devnull, device=device,
              **kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, res


@functools.cache
def _micro_array() -> np.ndarray:
    return np.random.default_rng(7).integers(0, 2**31, size=1 << 21,
                                             dtype=np.int64)


def steal_probe() -> float:
    """One sample of a fixed pure-CPU microbenchmark (numpy xor+popcount
    over a resident 16MB array).  The work is constant, so
    sample-to-sample ratios measure hypervisor steal / host contention,
    not the pipeline.  Returns seconds."""
    x = _micro_array()
    t0 = time.perf_counter()
    for _ in range(4):
        z = x ^ (x >> 1)
        np.bitwise_count(z).sum()
    return time.perf_counter() - t0


def sampling_done(samples, micro, elapsed: float, budget: float) -> bool:
    """``bench.py``'s stop rule over the sample times so far.

    ``samples[i]`` is run i's seconds; ``micro[0]`` the steal probe before
    the first run and ``micro[i + 1]`` the one after run i.  A run counts
    toward convergence when it does not improve the best by 2% and its
    probe was quiet (at most 1.5x the quickest probe so far).  Done at 7
    or more runs with 4 such runs since the last improvement, or at 3 or
    more once ``elapsed`` seconds exceed ``budget``."""
    best, since, quiet = None, 0, None
    for d, probe in zip(samples, micro[1:]):
        quiet = min(micro[0], probe) if quiet is None else min(quiet, probe)
        noisy = probe > 1.5 * quiet
        if best is None or d < best * 0.98:
            since = 0
        elif not noisy:
            since += 1
        best = d if best is None else min(best, d)
    n = len(samples)
    return (n >= 7 and since >= 4) or (n >= 3 and elapsed > budget)


def measure_baseline(fq: str, n_reads: int, distance: int, out_dir: str,
                     exe: str = HUMID_REF,
                     src: str = HUMID_REF_SRC) -> tuple[float, str]:
    """Single-core reference-semantics reads/s: the best of 2 runs of
    ``exe`` (built from ``src`` with g++ when missing or older than it)
    with ``-m distance -d out_dir`` on ``fq``, and "humid_ref"; or the
    estimate and "estimate" when it cannot be built or run."""
    try:
        if not os.path.exists(exe) or (
                os.path.getmtime(exe) < os.path.getmtime(src)):
            gxx = shutil.which("g++")
            if gxx is None:
                return BASELINE_READS_PER_SEC, "estimate"
            subprocess.run([gxx, "-O2", "-std=c++17", "-o", exe, src, "-lz"],
                           check=True)
        os.makedirs(out_dir, exist_ok=True)
        best = None
        for _ in range(2):
            t0 = time.perf_counter()
            subprocess.run([exe, "-m", str(distance), "-d", out_dir, fq],
                           check=True, capture_output=True)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return n_reads / best, "humid_ref"
    except (OSError, subprocess.CalledProcessError):
        return BASELINE_READS_PER_SEC, "estimate"


def card_line(device: torch.device) -> str | None:
    """nvidia-smi's "name, power limit" of the card, or None off a card."""
    if device.type != "cuda":
        return None
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
    except OSError:
        return None
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else None


def _mib(n: int) -> float:
    return round(n / 2**20, 1)


def rss_mib() -> float | None:
    """The process's resident set now (MiB; Linux's /proc), or None.  Not
    ``ru_maxrss``: that peak is inherited across fork and exec, so a child
    of a large process reports its parent's."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except OSError:
        return None
    return _mib(pages * os.sysconf("SC_PAGE_SIZE"))


def bench(n_reads: int, distance: int = 1, warmup: bool = True, *,
          work_dir: str, budget: float, humid_ref: str = HUMID_REF,
          device=None, runs: int | None = None) -> dict:
    """Run the bench in ``work_dir``; print its JSON line to stdout and
    bench.py's notes (and the warm-up, the samples, phase seconds and
    memory per run) to stderr; return the JSON record.  ``runs`` fixes
    the number of timed runs (default: ``sampling_done`` decides)."""
    dev = resolve_device(device)
    os.makedirs(work_dir, exist_ok=True)
    fq = os.path.join(work_dir, f"bench_{n_reads}.fastq")
    if not os.path.exists(fq):
        # Generate to a temp name and rename: an interrupted generation
        # must not leave a truncated file the cache check would reuse.
        tmp = f"{fq}.tmp.{os.getpid()}"
        gen_dataset(tmp, n_reads)
        os.replace(tmp, fq)
    files = [fq]
    out_dir = os.path.join(work_dir, "out")
    kw = dict(distance=distance, write_dedup=True)

    if warmup:
        d, _ = run_once(files, out_dir, dev, **kw)
        print(f"# warm-up run: {d:.3f} s", file=sys.stderr)
    # The sync drains dirty pages (e.g. from dataset generation) so
    # writeback does not fire mid-measurement.
    os.sync()
    t_bench = time.perf_counter()
    samples: list[float] = []
    micro = [steal_probe()]
    phases_best: dict[str, float] = {}
    phases_by_run: dict[str, list[float]] = {}
    memory = {"rss_mib": []}
    if dev.type == "cuda":
        memory.update(cuda_max_allocated_mib=[], cuda_allocated_mib=[])
    best, res = None, None
    while True:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        d, r = run_once(files, out_dir, dev, **kw)
        micro.append(steal_probe())
        samples.append(d)
        if dev.type == "cuda":
            memory["cuda_max_allocated_mib"].append(
                _mib(torch.cuda.max_memory_allocated(dev)))
            memory["cuda_allocated_mib"].append(
                _mib(torch.cuda.memory_allocated(dev)))
        memory["rss_mib"].append(rss_mib())
        for k, v in r.extra.get("timings", {}).items():
            phases_best[k] = min(phases_best.get(k, v), v)
            phases_by_run.setdefault(k, []).append(round(v, 4))
        if best is None or d <= best:
            best, res = d, r  # phases reported below come from the best run
        if (len(samples) >= runs if runs is not None else sampling_done(
                samples, micro, time.perf_counter() - t_bench, budget)):
            break

    rps = n_reads / best
    base_rps, base_source = measure_baseline(
        fq, n_reads, distance, os.path.join(work_dir, "out_ref"), humid_ref)
    ms = sorted(micro)
    ss = sorted(samples)
    record = {
        "metric": "reads_per_sec",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps / base_rps, 2),
        "baseline_reads_per_sec": round(base_rps, 1),
        "backend": dev.type,
        "engine": res.extra.get("engine", {}).get("strategy"),
        "n_runs": len(samples),
        "value_median": round(n_reads / ss[len(ss) // 2], 1),
        # median/best of a constant-work host probe: >~1.3 means the host
        # was contended during the bench.
        "steal_factor": round(ms[len(ms) // 2] / ms[0], 2),
        "tunnel_factor": None,
        "phases": {k: round(v, 3)
                   for k, v in res.extra.get("timings", {}).items()},
        # Per-phase minimum across all runs.
        "phases_best": {k: round(v, 3) for k, v in phases_best.items()},
        "baseline_source": base_source,
        "card": card_line(dev),
        # Which host C extensions imported, read as the router's cache
        # key reads them.
        "host_extensions": {name: flag == "1" for name, flag in zip(
            EXTENSIONS, _backend._host_extensions())},
    }
    print(json.dumps(record), flush=True)
    print(f"# baseline humid_ref: {base_rps:.0f} reads/s", file=sys.stderr)
    print(f"# {n_reads} reads in {best:.2f}s; unique={res.unique} "
          f"clusters={res.clusters} total={res.total}", file=sys.stderr)
    print(f"# samples (s): {json.dumps([round(s, 4) for s in samples])}",
          file=sys.stderr)
    print(f"# phase seconds per run: {json.dumps(phases_by_run)}",
          file=sys.stderr)
    print(f"# memory per timed run: {json.dumps(memory)}", file=sys.stderr,
          flush=True)
    return record


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reads", type=int, default=1_000_000)
    p.add_argument("--distance", type=int, default=1)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--runs", type=int, default=None,
                   help="timed runs (default: until the best stops "
                        "improving)")
    args = p.parse_args(argv)
    if args.runs is not None and args.runs < 1:
        p.error("--runs must be at least 1")
    bench(args.reads, args.distance, not args.no_warmup,
          work_dir=os.path.join(tempfile.gettempdir(),
                                "humid_tpu_torch_bench"),
          budget=max(90.0, args.reads / 80_000), runs=args.runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
