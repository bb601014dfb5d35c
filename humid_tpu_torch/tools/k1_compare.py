"""Time the tile sweep K1 beside an earlier build of it, in turns, on one
card, at the five shapes ``chip_smoke.py`` runs K1 at.

    python -m humid_tpu_torch.tools.k1_compare --popc-src DIR
        [--shapes sweep_1M,dense_1M,...] [--rounds 4] [--json FILE]

``DIR`` holds the bit-plane POPC form of K1 (the ``hamming_sweep.cu``
and ``hamming_common.cuh`` of the commit before the tensor-core form,
e.g. unpacked with ``git show <commit>:humid_tpu_torch/csrc/<file>``
into a git-ignored directory); it is built there with ``nvcc`` and
bound by its own C entry (packed lanes, no encoded table).  For each
shape both kernels must give the same pairs as the plain version (the
current K1 through its wrapper; the POPC build through a launch at the
exact capacity); then, in ``--rounds`` rounds that alternate the order
(current, POPC, POPC, current, ...), each kernel alone (its launches
into buffers allocated beforehand, between CUDA events, as
``chip_smoke.py::sweep_kernel_ms`` times them) and with max_dist -1
(no pair passes), and the current K1 through its wrapper, with its CUDA
encoder and with the encoder's plain version in its place
(``wrapper_plain_encode_ms``: the wrapper as it encoded before the
encoder).  Prints one JSON line per shape and the card's nvidia-smi
line; with ``--json`` the lines are also written to FILE.  Needs a CUDA card and nvcc.

The shapes (tables of ``tools/ring_profile.sample_table``, inputs of the
neighbour engines, as phases 3 and 6 of ``chip_smoke.py`` build them):
``sweep_1M`` and ``sweep_10M`` (bucketed inputs of 1M- and 10M-read
samples, w = 2, m = 1), ``dense_1M`` (every tile pair of the 1M-read
table: the main path's shape), ``dense_L33_m2`` (w = 3, m = 2) and
``ids_shard0`` (shard 0 of 4 of the bucketed mesh search, with its
run-id mask).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

SHAPES = ("sweep_1M", "sweep_10M", "dense_1M", "dense_L33_m2", "ids_shard0")
#: Peak int8 tensor-core rate of one H100 SXM, dense (NVIDIA's data sheet,
#: at its 700 W limit), in operations a second.
INT8_OPS_PER_S = 1.979e15
#: Device memory rate of one H100 SXM (bytes a second).
HBM_BYTES_PER_S = 3.35e12


def tensor_core_bound(evaluations: int, w: int, n_bytes: int,
                      channels: int) -> dict:
    """Least time of ``evaluations`` word pairs of ``w`` lanes in an int8
    tensor-core form with ``channels`` int8 channels a base (3: the
    simplex form K1 runs; 4: one-hot): the larger of the bytes over the
    memory rate and channels x 16 w multiply-adds a pair, 2 operations
    each, over the int8 rate."""
    ops_ms = evaluations * channels * 16 * w * 2 / INT8_OPS_PER_S * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def sweep_evaluations(n_rows, tile_pairs, tile, part_stride,
                      part_valid) -> int:
    """Word pairs a tile-pair list has to evaluate: valid rows x valid
    columns per tile pair, the strict upper triangle on a diagonal one."""
    g = np.arange(n_rows)
    valid = np.bincount(g[g % part_stride < part_valid] // tile,
                        minlength=-(-n_rows // tile)).astype(np.int64)
    vi, vj = valid[tile_pairs[:, 0]], valid[tile_pairs[:, 1]]
    diag = tile_pairs[:, 0] == tile_pairs[:, 1]
    return int(np.where(diag, vi * (vi - 1) // 2, vi * vj).sum())


def shape_inputs(name: str, tables: dict) -> dict:
    """Host inputs of one shape: rows [N, w] uint32, tile_pairs [nb, 2],
    tile, part_stride, part_valid, max_dist, ids ([N] int32 or None).
    ``tables`` caches the sample tables between shapes."""
    from ..ops.neighbors import bucketed_inputs, dense_inputs
    from ..parallel.neighbors import bucketed_shard_inputs
    from .ring_profile import sample_table

    def table(n_reads, *args, **kw):
        key = (n_reads, args, tuple(sorted(kw.items())))
        if key not in tables:
            tables[key] = sample_table(n_reads, *args, **kw)
        return tables[key]

    if name in ("sweep_1M", "sweep_10M"):
        n_reads = 1_000_000 if name == "sweep_1M" else 10_000_000
        uniq = table(n_reads, seed=n_reads % 997)
        rows, tps, b, u_pad, _ = bucketed_inputs(uniq, 1, 24, 2048)
        return dict(rows=rows, tile_pairs=tps, tile=b, part_stride=u_pad,
                    part_valid=len(uniq), max_dist=1, ids=None)
    if name == "dense_1M":
        uniq = table(1_000_000, seed=1_000_000 % 997)
        rows, tps, b, u_pad = dense_inputs(uniq, 2048)
        return dict(rows=rows, tile_pairs=tps, tile=b, part_stride=u_pad,
                    part_valid=len(uniq), max_dist=1, ids=None)
    if name == "dense_L33_m2":
        uniq = table(72_000, 33, seed=33, n_subst=2)
        rows, tps, b, u_pad = dense_inputs(uniq, 2048)
        return dict(rows=rows, tile_pairs=tps, tile=b, part_stride=u_pad,
                    part_valid=len(uniq), max_dist=2, ids=None)
    if name == "ids_shard0":
        uniq = table(1_000_000, seed=1_000_000 % 997)
        prep = bucketed_shard_inputs(uniq, 1, 24, 4)
        return dict(rows=prep["rows"][0], tile_pairs=prep["tile_pairs"][0],
                    tile=prep["tile"], part_stride=prep["r_pad"],
                    part_valid=prep["urows"][0], max_dist=1,
                    ids=prep["ids"][0])
    raise ValueError(f"unknown shape {name!r}; known: {', '.join(SHAPES)}")


def build_popc(src: Path, out_dir: Path):
    """Build the POPC form's ``hamming_sweep.cu`` from ``src`` into
    ``out_dir`` and bind its C entry (lanes, n_rows, w, ids, tile_pairs,
    nb, tile, part_stride, part_valid, max_dist, out_keys, cap, counter,
    stream)."""
    from .. import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libhamming_sweep_popc.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(src / "hamming_sweep.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).humid_hamming_sweep
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, i64, i32, p, p, i64, i32, i64, i64, i32, p, i64, p, p]
    fn.restype = ctypes.c_int
    return fn


def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up
    (CUDA events around the whole loop)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, kernel: str, launches: int) -> float | None:
    """Mean device milliseconds of kernel ``kernel`` a run of ``fn()``,
    from a ``torch.profiler`` trace of ``reps`` runs after one warm-up:
    the summed durations of the trace's kernel events whose name holds
    ``kernel``, over ``reps``.  The host's set-up between launches is not
    in it.  None where the trace holds other than ``launches`` such events
    a run (a trace that lost events)."""
    import os
    import tempfile

    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    durs = [e["dur"] for e in events if e.get("ph") == "X"
            and e.get("cat") == "kernel" and kernel in e.get("name", "")]
    if len(durs) != reps * launches:
        return None
    return sum(durs) / reps / 1e3


def compare_shape(name: str, inp: dict, popc, rounds: int,
                  reps: int) -> dict:
    """Both kernels at one shape: pairs against the plain version, then
    the timings in alternating turns (module docstring)."""
    import torch

    from ..ops import cuda_hamming as K
    from ..ops.neighbors import sweep_tensors

    dev = torch.device("cuda")
    lanes, tp = sweep_tensors(inp["rows"], inp["tile_pairs"], dev)
    ids = None if inp["ids"] is None else torch.from_numpy(
        inp["ids"]).to(dev)
    kw = {k: inp[k] for k in ("tile", "part_stride", "part_valid",
                              "max_dist")}
    n_rows, w = lanes.shape
    want = K.hamming_tile_pairs_plain(lanes, tp, ids=ids, **kw)
    got = K.hamming_tile_pairs(lanes, tp, ids=ids, **kw)
    n_pairs = len(want[0])
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"{name}: the current K1 differs from the "
                             f"plain version")
    table = K.encode_table(lanes)
    keys = torch.empty(max(n_pairs, 1), dtype=torch.int64, device=dev)
    counter = torch.zeros(2, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def current(max_dist):
        def run():
            counter.zero_()
            for lo in range(0, len(tp), K.CHUNK_PAIRS):
                K._launch(lanes, tp[lo:lo + K.CHUNK_PAIRS], keys, counter,
                          **{**kw, "max_dist": max_dist}, ids=ids,
                          table=table)
        return run

    def popc_form(max_dist):
        def run():
            counter.zero_()
            for lo in range(0, len(tp), K.CHUNK_PAIRS):
                chunk = tp[lo:lo + K.CHUNK_PAIRS]
                err = popc(lanes.data_ptr(), n_rows, w,
                           None if ids is None else ids.data_ptr(),
                           chunk.data_ptr(), len(chunk), kw["tile"],
                           kw["part_stride"], kw["part_valid"], max_dist,
                           keys.data_ptr(), len(keys), counter.data_ptr(),
                           stream)
                if err:
                    raise RuntimeError(f"POPC K1 launch failed: {err}")
        return run

    popc_form(kw["max_dist"])()
    torch.cuda.synchronize()
    if counter.tolist() != [n_pairs, 0]:
        raise AssertionError(f"{name}: the POPC K1 counted "
                             f"{counter.tolist()}, expected [{n_pairs}, 0]")
    popc_keys = torch.sort(keys[:n_pairs]).values
    if not torch.equal(popc_keys, want[0] * n_rows + want[1]):
        raise AssertionError(f"{name}: the POPC K1 differs from the plain "
                             f"version")
    times = {k: [] for k in ("kernel_ms", "no_hit_kernel_ms", "popc_ms",
                             "popc_no_hit_ms", "wrapper_ms",
                             "wrapper_plain_encode_ms")}

    def wrapper_plain_encode():
        # The wrapper with the encoder's plain version in the CUDA
        # encoder's place: how the wrapper encoded before the encoder.
        K.encode = K.encode_table
        try:
            K.hamming_tile_pairs(lanes, tp, ids=ids, **kw)
        finally:
            K.encode = encode

    encode = K.encode
    for r in range(rounds):
        order = ("current", "popc") if r % 2 == 0 else ("popc", "current")
        for which in order:
            if which == "current":
                times["kernel_ms"].append(
                    time_cuda(current(kw["max_dist"]), reps))
                times["no_hit_kernel_ms"].append(time_cuda(current(-1), reps))
                times["wrapper_ms"].append(time_cuda(
                    lambda: K.hamming_tile_pairs(lanes, tp, ids=ids, **kw),
                    max(reps // 4, 1)))
                times["wrapper_plain_encode_ms"].append(time_cuda(
                    wrapper_plain_encode, max(reps // 4, 1)))
            else:
                times["popc_ms"].append(
                    time_cuda(popc_form(kw["max_dist"]), reps))
                times["popc_no_hit_ms"].append(
                    time_cuda(popc_form(-1), reps))
    evaluations = sweep_evaluations(n_rows, inp["tile_pairs"], kw["tile"],
                                    kw["part_stride"], kw["part_valid"])
    n_bytes = (table.numel() + tp.numel() * 4 + 8 * n_pairs
               + (0 if ids is None else ids.numel() * 4))
    bound = tensor_core_bound(evaluations, w, n_bytes, channels=3)
    best = min(times["kernel_ms"])
    out = {"shape": name, "rows": n_rows, "w": w, "tile_pairs": len(tp),
           "pairs": n_pairs, "evaluations": evaluations,
           "max_abs_err": 0, "rounds": rounds, "reps": reps, **times,
           "form": "int8_simplex", **bound,
           "bound_share": bound["bound_ms"] / best,
           "onehot_bound_ms": tensor_core_bound(
               evaluations, w, n_bytes, channels=4)["bound_ms"],
           "current_over_popc": best / min(times["popc_ms"])}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--popc-src", type=Path, required=True)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k1_compare needs a CUDA card", file=sys.stderr)
        return 1
    from .. import _build

    popc = build_popc(args.popc_src.resolve(),
                      _build.BUILD_DIR / "k1_compare")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    tables: dict = {}
    lines = []
    for name in args.shapes.split(","):
        lines.append(compare_shape(name, shape_inputs(name, tables), popc,
                                   args.rounds, args.reps))
    print(smi, flush=True)
    if args.json:
        args.json.write_text("".join(json.dumps({**ln, "card": smi}) + "\n"
                                     for ln in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
