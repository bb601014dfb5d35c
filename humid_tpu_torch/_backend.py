"""Engine router: which engine runs a hot phase on this machine.

Every engine is measured at two probe sizes (``PROBE_READS``: 2^19 and
2^21 reads of the benchmark recipe, about 94K and 375K unique words) and
stored as two parameters, a fixed cost and a size cost, both in
nanoseconds: ``t(x) = a + b·x`` for the engines whose work grows with
the table (host ``runs``, ``bucketed``, ``runs_device``, the bucketed
mesh search, the -x components; x in unique words) and with the reads
(unique counting, the fused route; x in reads), and ``t(u) = a + c·u²``
for the dense tile sweep, which compares every pair.  A decision compares
the predicted times at the caller's own size.  The parameters are
measured once per (card name, CPU count, card count, host extensions) on
first use and cached on disk (:func:`engine_constants`).  On the CPU
device the router answers with the host engines and never measures.

Counterpart of ``humid_tpu/_backend.py`` without its dispatch-latency
probe: a device that the port runs on is attached to this host, so
"co-located" is "the resolved device is ``cuda``".  The reference fits
one linear constant per engine and leaves its dense ring out of the pick
for that reason; the quadratic term lets the dense sweep in.

Environment:

  HUMID_TPU_TORCH_DEVICE_ENGINE=1|device|on   force the device engines
  HUMID_TPU_TORCH_DEVICE_ENGINE=0|host|off    force the host engines
  HUMID_TPU_TORCH_FUSED=1|on / 0|off          force the fused route on/off
  HUMID_TPU_TORCH_CALIBRATION=off             measure nothing; a CUDA
                                              device then takes the
                                              device engines
  HUMID_TPU_TORCH_CALIB_PATH                  the cache file
                                              (~/.cache/humid_tpu_torch/
                                              engine_calib.json)

To measure again, delete the cache file (or name a new one) or call
``engine_constants(device, refresh=True)``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

#: Bumped when an engine's cost or the row's form changes (drops cached
#: rows).  3: two probes, two parameters an engine, the dense row.
_CALIB_VERSION = 3

#: Reads of the two calibration probes.
PROBE_READS = (1 << 19, 1 << 21)

#: This process's constants, read from the cache or measured once.
_CALIB: dict | None = None

#: Neighbour engines the router picks from (find_neighbor_pairs
#: strategies) and their calibration keys.  The bucketed mesh search's
#: row is measured only with several cards; it is a candidate wherever
#: the row exists.
_NEIGHBOR_ENGINES = {
    "runs": "neighbors_runs_ns",                    # host
    "bucketed": "neighbors_bucketed_ns",            # tile sweep K1, runs
    "runs_device": "neighbors_runs_device_ns",      # device run sweeps
    "dense": "neighbors_dense_ns",                  # K1, every tile pair
    "sharded_bucketed": "neighbors_sharded_ns",     # the cards' mesh
}

#: Rows whose size cost grows with the square of the table.
_QUADRATIC = {"neighbors_dense_ns"}

#: Rows whose size is the probe's reads (the rest: its unique words).
_PER_READ = {"unique_host_ns", "unique_device_ns", "pipeline_fused_ns"}

#: Engines that honour find_neighbor_pairs' host ``shard`` (the mesh
#: strategies search their whole table instead): the choices of a
#: multi-process run.
_SHARDABLE_ENGINES = {"runs", "bucketed", "runs_device", "dense"}

#: The rows every calibration has (the mesh row needs several cards).
_SINGLE_CARD_ROWS = [k for s, k in _NEIGHBOR_ENGINES.items()
                     if s != "sharded_bucketed"]


def _forced() -> bool | None:
    env = os.environ.get("HUMID_TPU_TORCH_DEVICE_ENGINE", "").lower()
    if env in ("1", "device", "on"):
        return True
    if env in ("0", "host", "off"):
        return False
    return None


def _calib_path() -> str:
    return os.environ.get(
        "HUMID_TPU_TORCH_CALIB_PATH",
        os.path.join(os.path.expanduser("~"), ".cache", "humid_tpu_torch",
                     "engine_calib.json"))


def _host_extensions() -> str:
    """Which host C extensions this install has built, as "hostops,
    ccluster, cfastqio" flags: they set the host engines' constants."""
    from .cluster import exact
    from .io import reader
    from .ops import unique

    built = (unique._unique_packed is not None, exact._native is not None,
             reader._frame_native is not None)
    return "".join("1" if b else "0" for b in built)


def _calib_key(device: torch.device) -> str:
    return (f"v{_CALIB_VERSION}|{torch.cuda.get_device_name(device)}"
            f"|ncpu={os.cpu_count()}|ngpu={torch.cuda.device_count()}"
            f"|ext={_host_extensions()}")


def _gen_probe_words(n: int, word_length: int = 24, seed: int = 0):
    """[n, w] uint32 packed words with the benchmark's duplicate structure
    (a pool of n/8 words, 30% of the draws with one substitution), drawn
    with a seeded ``torch.Generator``."""
    from . import words as W

    g = torch.Generator().manual_seed(seed)
    pool = torch.randint(0, 4, (n // 8, word_length), generator=g,
                         dtype=torch.uint8)
    codes = pool[torch.randint(0, len(pool), (n,), generator=g)]
    rows = torch.nonzero(torch.rand(n, generator=g) < 0.3).flatten()
    codes[rows, torch.randint(0, word_length, (len(rows),), generator=g)] = (
        torch.randint(0, 4, (len(rows),), generator=g, dtype=torch.uint8))
    return W.pack_words(codes.numpy())


def _fit(xs, ts_ns, quadratic: bool) -> list[float]:
    """[a, b] of ``t = a + b·x`` (``x²`` when ``quadratic``) through the
    two probes' (size, ns), held to a >= 0 and b >= 0: a time that fell
    with the size keeps the larger probe's time as a fixed cost, and a
    negative fixed cost becomes 0 with the line through the larger
    probe."""
    (x1, x2), (t1, t2) = ([float(x) ** (2 if quadratic else 1) for x in xs],
                          [float(t) for t in ts_ns])
    b = (t2 - t1) / (x2 - x1)
    if b < 0:
        return [t2, 0.0]
    a = t1 - b * x1
    if a < 0:
        return [0.0, t2 / x2]
    return [a, b]


def predict_ns(c: dict, key: str, size: float) -> float:
    """Row ``key``'s predicted nanoseconds at ``size`` (reads or unique
    words, as the row counts them)."""
    a, b = c[key]
    return float(a) + float(b) * float(size) ** (2 if key in _QUADRATIC
                                                 else 1)


def _measure_engines(device: torch.device) -> dict:
    """Each engine's time at both probes, best of 3 after a warm-up, the
    two parameters fitted to them, and the worst relative spread of the
    samples (max / best - 1) across engines and probes: the noise floor
    of a routing decision."""
    from .cluster import (cluster_exact, cluster_max_from_components,
                          connected_components_device)
    from .ops import pairs_to_csr, unique_words
    from .ops.fused import fused_probe
    from .ops.neighbors import find_neighbor_pairs
    from .ops.unique import unique_words_device
    from .parallel import data_mesh

    print("# humid_tpu_torch: calibrating host against device engines "
          "(once per card, CPU count, card count and host extensions; "
          "cached)", file=sys.stderr)
    t_start = time.perf_counter()
    wl = 24
    spreads: list[float] = []
    secs: dict[str, list[float]] = {}
    probe_n, probe_u = [], []

    def best(key, fn, n=3):
        fn()
        samples = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            samples.append(time.perf_counter() - t0)
        b = min(samples)
        spreads.append(max(samples) / b - 1.0 if b > 0 else 0.0)
        secs.setdefault(key, []).append(b)

    mesh = (data_mesh(torch.cuda.device_count(), device)
            if torch.cuda.device_count() > 1 else None)
    for n_reads in PROBE_READS:
        packed = _gen_probe_words(n_reads, wl)
        best("unique_host_ns", lambda: unique_words(packed))
        best("unique_device_ns",
             lambda: unique_words_device(packed, device=device))
        uniq, counts = unique_words(packed, want_inverse=False)[:2]
        u = len(uniq)
        probe_n.append(len(packed))
        probe_u.append(u)
        nb = lambda strategy, **kw: find_neighbor_pairs(
            uniq, 1, word_length=wl, strategy=strategy, device=device, **kw)
        for s, k in _NEIGHBOR_ENGINES.items():
            if s != "sharded_bucketed":
                best(k, lambda s=s: nb(s))
            elif mesh is not None:
                best(k, lambda: nb(s, mesh=mesh))
        pa, pb = nb("runs")
        indptr, indices = pairs_to_csr(pa, pb, u)
        best("cc_host_ns",
             lambda: cluster_exact(counts, indptr, indices, maximum=True))
        best("cc_device_ns", lambda: cluster_max_from_components(
            counts, indptr, indices,
            connected_components_device(pa, pb, u, device=device)))
        best("pipeline_fused_ns",
             lambda: fused_probe(packed, wl, 1, device=device))
    out = {k: _fit(probe_n if k in _PER_READ else probe_u,
                   [t * 1e9 for t in ts], k in _QUADRATIC)
           for k, ts in secs.items()}
    out.update({
        "probe_ms": {k: [t * 1e3 for t in ts] for k, ts in secs.items()},
        "spread": max(spreads),
        "probe_n": probe_n, "probe_u": probe_u,
        "seconds": time.perf_counter() - t_start,
        "device": torch.cuda.get_device_name(device),
        "ts": time.time(),
    })
    return out


def engine_constants(device: torch.device, refresh: bool = False
                     ) -> dict | None:
    """The measured parameters of this machine (disk-cached per card name,
    CPU count, card count and host extensions), or None on the CPU device
    or with HUMID_TPU_TORCH_CALIBRATION=off.  ``refresh`` measures
    again."""
    global _CALIB
    if device.type != "cuda" or os.environ.get(
            "HUMID_TPU_TORCH_CALIBRATION", "").lower() in ("off", "0", "no"):
        return None
    if _CALIB is not None and not refresh:
        return _CALIB
    cache = _load_cache()
    key = _calib_key(device)
    if key in cache and not refresh:
        _CALIB = cache[key]
        return _CALIB
    _CALIB = _measure_engines(device)
    _save_calib(key, _CALIB)
    return _CALIB


def _load_cache() -> dict:
    try:
        with open(_calib_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_calib(key: str, entry: dict) -> None:
    """Write this machine's entry, keeping the other machines' rows."""
    path = _calib_path()
    cache = _load_cache()
    cache[key] = entry
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=1)
        os.replace(tmp, path)
    except OSError:
        pass  # read-only home: keep the constants of this process


def _tie(times: list[float], spread: float) -> bool:
    """Are the best two of ``times`` closer than the measured spread?"""
    vals = sorted(times)
    return (len(vals) >= 2
            and (vals[1] - vals[0]) / max(vals[0], 1e-9) < spread)


def _noise_guarded(c: dict, times, device: torch.device) -> dict:
    """When the best two of the predicted times ``times(c)`` are closer
    than the measured spread and the measurement is over an hour old,
    measure once more; a measurement that ties again is stamped
    ``tied_ts``, which stops such refreshes for 30 days (either engine is
    fine while they tie)."""
    if (not _tie(times(c), float(c.get("spread", 0.0)))
            or time.time() - float(c.get("ts", 0.0)) <= 3600.0
            or time.time() - float(c.get("tied_ts", 0.0)) < 30 * 86400.0):
        return c
    c2 = engine_constants(device, refresh=True)
    if c2 is None:
        return c
    if _tie(times(c2), float(c2.get("spread", 0.0))):
        c2["tied_ts"] = time.time()
        _save_calib(_calib_key(device), c2)
    return c2


def _constants(device: torch.device, need) -> dict | None:
    """The constants, measured again if the cached row lacks a key."""
    c = engine_constants(device)
    if c is not None and any(k not in c for k in need):
        c = engine_constants(device, refresh=True)
    return c


def neighbor_times_ns(c: dict, u: int, shardable_only: bool = False
                      ) -> dict[str, float]:
    """Each candidate neighbour engine's predicted nanoseconds for a table
    of ``u`` unique words (the engines whose rows ``c`` holds)."""
    return {s: predict_ns(c, k, u) for s, k in _NEIGHBOR_ENGINES.items()
            if k in c and not (shardable_only
                               and s not in _SHARDABLE_ENGINES)}


def pick_neighbor_engine(device: torch.device, u: int,
                         shardable_only: bool = False) -> str:
    """The neighbour engine of ``auto`` for a Hamming table of ``u``
    unique words above the size gate (a find_neighbor_pairs strategy):
    ``runs`` on the CPU device or with the host engines forced; else the
    engine predicted fastest at ``u`` of host ``runs``, ``bucketed``,
    ``runs_device``, ``dense`` and, where its row was measured (several
    cards), ``sharded_bucketed``, where a device engine must beat the host
    one by 10% so that noise does not flip the route.  Forced device
    engines take the fastest device engine, and without constants
    ``runs_device``.  ``shardable_only`` keeps to the engines that honour
    a host ``shard`` (``_SHARDABLE_ENGINES``)."""
    forced = _forced()
    if forced is False or (forced is None and device.type != "cuda"):
        return "runs"
    c = _constants(device, _SINGLE_CARD_ROWS)
    if c is None:
        return "runs_device"
    c = _noise_guarded(
        c, lambda c: list(neighbor_times_ns(c, u, shardable_only).values()),
        device)
    times = neighbor_times_ns(c, u, shardable_only)
    dev_engines = {s: t for s, t in times.items() if s != "runs"}
    best_dev = min(dev_engines, key=dev_engines.get)
    if forced or dev_engines[best_dev] < 0.9 * times["runs"]:
        return best_dev
    return "runs"


def use_device_engine(kind: str, device: torch.device,
                      size: int | None = None) -> bool:
    """Run phase ``kind`` ("unique" over ``size`` reads, or "cc": the -x
    components of ``size`` unique words) on ``device``?  The forced
    answer if one is set; False on the CPU device; True without
    constants; else whether the device engine is predicted 10% faster
    than the host one at ``size`` (default: the smaller probe's)."""
    keys = {"unique": ("unique_device_ns", "unique_host_ns"),
            "cc": ("cc_device_ns", "cc_host_ns")}
    if kind not in keys:
        raise ValueError(f"unknown engine kind {kind!r}")
    forced = _forced()
    if forced is not None:
        return forced
    if device.type != "cuda":
        return False
    dev_k, host_k = keys[kind]
    c = _constants(device, [dev_k, host_k])
    if c is None:
        return True
    if size is None:
        size = c["probe_n" if kind == "unique" else "probe_u"][0]
    times = lambda c: [predict_ns(c, dev_k, size),
                       predict_ns(c, host_k, size)]
    dev_t, host_t = times(_noise_guarded(c, times, device))
    return dev_t < 0.9 * host_t


def fused_times_ns(c: dict, n: int) -> tuple[float, float]:
    """(fused route, best phase-wise route) predicted for ``n`` reads: the
    phase-wise route is the best unique engine at ``n`` plus the best
    neighbour engine at ``u = n · probe_u / probe_n`` (the larger
    probe's ratio)."""
    u = n * float(c["probe_u"][-1]) / max(float(c["probe_n"][-1]), 1.0)
    best_unique = min(predict_ns(c, "unique_host_ns", n),
                      predict_ns(c, "unique_device_ns", n))
    best_nb = min(neighbor_times_ns(c, u).values())
    return predict_ns(c, "pipeline_fused_ns", n), best_unique + best_nb


def use_fused_pipeline(device: torch.device, n: int) -> bool:
    """Take the fused device-resident route (:mod:`.ops.fused`) for unique
    counting and the neighbour search of ``n`` reads?
    HUMID_TPU_TORCH_FUSED=1/0 decides outright; forced host engines or the
    CPU device say no (forced device engines say yes); without constants a
    CUDA device says yes; else when its predicted time beats the best
    phase-wise route's (:func:`fused_times_ns`) by more than the larger of
    10% and the calibration's spread, so that a difference inside the
    noise always gives the phase-wise route.  The answer is a function of
    the constants and ``n`` alone: calls with the same row always
    agree."""
    env = os.environ.get("HUMID_TPU_TORCH_FUSED", "").lower()
    if env in ("1", "on", "fused"):
        return True
    if env in ("0", "off"):
        return False
    forced = _forced()
    if forced is not None:
        return forced
    if device.type != "cuda":
        return False
    need = ["pipeline_fused_ns", "unique_host_ns", "unique_device_ns",
            "probe_n", "probe_u", *_SINGLE_CARD_ROWS]
    c = _constants(device, need)
    if c is None:
        return True
    fused, phase_wise = fused_times_ns(c, n)
    margin = max(0.1, float(c.get("spread", 0.0)))
    return fused < (1.0 - margin) * phase_wise


def _reset_for_tests() -> None:
    global _CALIB
    _CALIB = None
