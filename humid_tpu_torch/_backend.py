"""Engine router: which engine runs a hot phase on this machine.

The host and the device engines of a phase are all linear in the size of
their input, so one measured constant per engine (nanoseconds per row or
per unique word, on a probe of 2^19 words) decides the route for every
size.  The constants are measured once per (card name, CPU count, card
count) on first use and cached on disk (:func:`engine_constants`).  On
the CPU device the router answers with the host engines and never
measures.

Counterpart of ``humid_tpu/_backend.py`` without its dispatch-latency
probe: a device that the port runs on is attached to this host, so
"co-located" is "the resolved device is ``cuda``".

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

#: Bumped when an engine's cost changes materially (drops cached rows).
_CALIB_VERSION = 2

#: This process's constants, read from the cache or measured once.
_CALIB: dict | None = None

#: Neighbour engines the router picks from (find_neighbor_pairs
#: strategies; cost per unique word flat in the table size) and their
#: calibration keys.  With several cards the bucketed mesh search is
#: measured too ("neighbors_sharded_ns") but not picked: no run on
#: several cards has measured it yet.
_NEIGHBOR_ENGINES = {
    "runs": "neighbors_runs_ns",                    # host
    "bucketed": "neighbors_bucketed_ns",            # tile sweep K1
    "runs_device": "neighbors_runs_device_ns",      # device run sweeps
}

#: Engines that honour find_neighbor_pairs' host ``shard`` (the mesh
#: strategies search their whole table instead): the choices of a
#: multi-process run.
_SHARDABLE_ENGINES = {"runs", "bucketed", "runs_device"}


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


def _measure_engines(device: torch.device) -> dict:
    """Each engine's cost on the probe, best of 3 after a warm-up, and the
    worst relative spread of the samples (max / best - 1) across engines:
    the noise floor of a routing decision."""
    from .cluster import (cluster_exact, cluster_max_from_components,
                          connected_components_device)
    from .ops import pairs_to_csr, unique_words
    from .ops.fused import fused_probe
    from .ops.neighbors import find_neighbor_pairs
    from .ops.unique import unique_words_device
    from .parallel import data_mesh

    print("# humid_tpu_torch: calibrating host against device engines "
          "(once per card, CPU count and card count; cached)",
          file=sys.stderr)
    wl = 24
    packed = _gen_probe_words(1 << 19, wl)
    spreads: list[float] = []

    def best(fn, n=3):
        fn()
        samples = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            samples.append(time.perf_counter() - t0)
        b = min(samples)
        spreads.append(max(samples) / b - 1.0 if b > 0 else 0.0)
        return b

    t_uh = best(lambda: unique_words(packed))
    t_ud = best(lambda: unique_words_device(packed, device=device))
    uniq, counts = unique_words(packed, want_inverse=False)[:2]
    u = len(uniq)
    nb = lambda strategy, **kw: find_neighbor_pairs(
        uniq, 1, word_length=wl, strategy=strategy, device=device, **kw)
    t_n = {_NEIGHBOR_ENGINES[s]: best(lambda s=s: nb(s))
           for s in _NEIGHBOR_ENGINES}
    if torch.cuda.device_count() > 1:
        mesh = data_mesh(torch.cuda.device_count(), device)
        t_n["neighbors_sharded_ns"] = best(lambda: nb("sharded_bucketed",
                                                      mesh=mesh))
    pa, pb = nb("runs")
    indptr, indices = pairs_to_csr(pa, pb, u)
    t_ch = best(lambda: cluster_exact(counts, indptr, indices, maximum=True))
    t_cd = best(lambda: cluster_max_from_components(
        counts, indptr, indices,
        connected_components_device(pa, pb, u, device=device)))
    t_fp = best(lambda: fused_probe(packed, wl, 1, device=device))
    return {
        "unique_host_ns": t_uh / len(packed) * 1e9,
        "unique_device_ns": t_ud / len(packed) * 1e9,
        **{k: t / u * 1e9 for k, t in t_n.items()},
        "cc_host_ns": t_ch / u * 1e9,
        "cc_device_ns": t_cd / u * 1e9,
        "pipeline_fused_ns": t_fp / len(packed) * 1e9,
        "spread": max(spreads),
        "probe_n": len(packed), "probe_u": u,
        "device": torch.cuda.get_device_name(device),
        "ts": time.time(),
    }


def engine_constants(device: torch.device, refresh: bool = False
                     ) -> dict | None:
    """The measured constants of this machine (disk-cached per card name,
    CPU count and card count), or None on the CPU device or with
    HUMID_TPU_TORCH_CALIBRATION=off.  ``refresh`` measures again."""
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


def _noise_guarded(c: dict, ks: list[str], device: torch.device) -> dict:
    """When the best two of the engines ``ks`` are closer than the measured
    spread and the measurement is over an hour old, measure once more; a
    measurement that ties again is stamped ``tied_ts``, which stops such
    refreshes for 30 days (either engine is fine while they tie)."""
    vals = sorted(float(c[k]) for k in ks if k in c)
    if len(vals) < 2:
        return c
    margin = (vals[1] - vals[0]) / max(vals[0], 1e-9)
    if (margin >= float(c.get("spread", 0.0))
            or time.time() - float(c.get("ts", 0.0)) <= 3600.0
            or time.time() - float(c.get("tied_ts", 0.0)) < 30 * 86400.0):
        return c
    c2 = engine_constants(device, refresh=True)
    if c2 is None:
        return c
    vals = sorted(float(c2[k]) for k in ks if k in c2)
    if len(vals) >= 2 and ((vals[1] - vals[0]) / max(vals[0], 1e-9)
                           < float(c2.get("spread", 0.0))):
        c2["tied_ts"] = time.time()
        _save_calib(_calib_key(device), c2)
    return c2


def _constants(device: torch.device, need) -> dict | None:
    """The constants, measured again if the cached row lacks a key."""
    c = engine_constants(device)
    if c is not None and any(k not in c for k in need):
        c = engine_constants(device, refresh=True)
    return c


def pick_neighbor_engine(device: torch.device,
                         shardable_only: bool = False) -> str:
    """The neighbour engine of ``auto`` for Hamming tables above the size
    gate (a find_neighbor_pairs strategy): ``runs`` on the CPU device or
    with the host engines forced; else the measured fastest of host
    ``runs``, ``bucketed`` and ``runs_device``, where a device engine must
    beat the host one by 10% so that noise does not flip the route.  Forced device engines
    take the fastest device engine, and without constants
    ``runs_device``.  ``shardable_only`` keeps to the engines that honour
    a host ``shard`` (``_SHARDABLE_ENGINES``; every engine the router
    picks from does today)."""
    forced = _forced()
    if forced is False or (forced is None and device.type != "cuda"):
        return "runs"
    c = _constants(device, list(_NEIGHBOR_ENGINES.values()))
    if c is None:
        return "runs_device"
    c = _noise_guarded(c, list(_NEIGHBOR_ENGINES.values()), device)
    dev_engines = {s: float(c[k]) for s, k in _NEIGHBOR_ENGINES.items()
                   if s != "runs" and not (shardable_only
                                           and s not in _SHARDABLE_ENGINES)}
    best_dev = min(dev_engines, key=dev_engines.get)
    if forced or dev_engines[best_dev] < 0.9 * float(c["neighbors_runs_ns"]):
        return best_dev
    return "runs"


def use_device_engine(kind: str, device: torch.device) -> bool:
    """Run phase ``kind`` ("unique", or "cc": the -x components) on
    ``device``?  The forced answer if one is set; False on the CPU device;
    True without constants; else whether the device engine measured 10%
    faster than the host one."""
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
    c = _noise_guarded(c, [dev_k, host_k], device)
    return float(c[dev_k]) < 0.9 * float(c[host_k])


def use_fused_pipeline(device: torch.device) -> bool:
    """Take the fused device-resident route (:mod:`.ops.fused`) for unique
    counting and the neighbour search?  HUMID_TPU_TORCH_FUSED=1/0 decides
    outright; forced host engines or the CPU device say no (forced device
    engines say yes); without constants a CUDA device says yes; else when
    its measured constant beats the best phase-wise alternative (best
    unique engine + best neighbour engine, per read) by 10%."""
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
            "probe_n", "probe_u", *_NEIGHBOR_ENGINES.values()]
    c = _constants(device, need)
    if c is None:
        return True
    ratio = float(c["probe_u"]) / max(float(c["probe_n"]), 1.0)
    best_unique = min(float(c["unique_host_ns"]),
                      float(c["unique_device_ns"]))
    best_nb = min(float(c[k]) for k in _NEIGHBOR_ENGINES.values())
    return float(c["pipeline_fused_ns"]) < 0.9 * (best_unique
                                                  + best_nb * ratio)


def _reset_for_tests() -> None:
    global _CALIB
    _CALIB = None
