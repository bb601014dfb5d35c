"""Time named design variants of the tile sweep K1 beside it, in turns, on
one card, at the shapes of ``k1_compare``.

    python -m humid_tpu_torch.tools.k1_variants [--variants a,b,...]
        [--shapes dense_1M,...] [--rounds 2] [--popc-src DIR]
        [--parent-src DIR] [--json FILE]

Each variant is the package's ``csrc/`` copied to
``build/humid_tpu_torch/k1_variants/<name>/`` with the text replacements
of :data:`VARIANTS` applied to ``hamming_sweep.cu`` or the pipeline it
includes, ``tc_sweep.cuh`` (:data:`SOURCES`; each text must occur once in
them), and ``hamming_sweep.cu`` built there with ``nvcc`` (a replacement
that no longer matches the sources raises).  For
each shape every variant's pairs must equal the plain version's; then,
in ``--rounds`` rounds that reverse the order each time, each variant's
kernel alone (its launches into buffers allocated beforehand, between
CUDA events; ``kernel_ms``) and, with ``--popc-src``, the POPC form of
``k1_compare``; each variant's kernel also by its device time in a
``torch.profiler`` trace of the same launches (``device_ms``,
``k1_compare.device_ms``: without the host's set-up between launches).
With ``--parent-src DIR`` the variant "parent" is DIR's own
``hamming_sweep.cu`` and headers, built as they are: an earlier
tensor-core K1 with the same C entry (e.g. unpacked from a commit with
``git show``), timed in the same turns.
One JSON line per shape and the card's nvidia-smi line.  Needs a CUDA
card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .k1_compare import (SHAPES, build_popc, device_ms, shape_inputs,
                         time_cuda)

_SIMPLEX_K = "static constexpr int K = (48 * W + KSTEP - 1) / KSTEP * KSTEP;"

#: The files of ``csrc/`` that the replacements apply to.
SOURCES = ("hamming_sweep.cu", "tc_sweep.cuh")

#: Variant name -> (encoding of the table, replacements in
#: :data:`SOURCES`).  "current" is the source as it is.
VARIANTS = {
    "current": ("simplex", []),
    # The one-hot encoding (4 channels a base, K = 64 w; the TPU kernel's
    # form), with 256-column products up to K = 128 (w = 2); instances
    # whose stages no longer fit shared memory are left unchecked (only
    # w <= 4 is run here).
    "onehot": ("onehot", [
        (_SIMPLEX_K, "static constexpr int K = 64 * W;"),
        ("  return (48 * w + KSTEP - 1) / KSTEP * KSTEP;",
         "  return 64 * w;"),
        ("static constexpr int BN = K <= 96 && !NARROW ? 256",
         "static constexpr int BN = K <= 128 && !NARROW ? 256"),
        ('static_assert(SMEM <= SMEM_LIMIT, "shared memory");', "")]),
    # 128-column products at w <= 2 (64 accumulators a thread) for every
    # list, or for none (the current source takes them for short lists).
    "bn128": ("simplex", [
        ("static constexpr int BN = K <= 96 && !NARROW ? 256 : K <= 192 ? "
         "128 : 64;", "static constexpr int BN = K <= 192 ? 128 : 64;")]),
    "wide_only": ("simplex", [
        ("    if (tc::plan<W>(nb, a.tile, a.tile).units < tc::MIN_UNITS)",
         "    if (false)")]),
    # Row panels of 256 rows (4 sub-blocks) at w <= 2.
    "sub4": ("simplex", [
        ("static constexpr int SUB = bytes(8, 2, 4) <= SMEM_LIMIT   ? 8",
         "static constexpr int SUB = bytes(8, 2, 4) < 0 ? 8")]),
    # The hit buffer flushed after every stage that added a key.
    "flush_every_stage": ("simplex", [
        ("                HIT_CAP / 2);", "                1u);")]),
    # The span halved until 2,048 units (the POPC form's list length).
    "min_units_2048": ("simplex", [
        ("constexpr int MIN_UNITS = 512;", "constexpr int MIN_UNITS = 2048;")]),
}


def build_variant(name: str, out_root: Path, src: Path | None = None):
    """Build variant ``name`` (:data:`VARIANTS`), or the sources in ``src``
    as they are, and bind its C entry."""
    from .. import _build

    d = out_root / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src or _build.CSRC, d)
    texts = {f: (d / f).read_text() for f in SOURCES if src is None}
    for old, new in (VARIANTS[name][1] if src is None else []):
        where = [f for f in SOURCES if old in texts[f]]
        if sum(texts[f].count(old) for f in SOURCES) != 1:
            raise ValueError(f"variant {name}: {old!r} is not once in "
                             f"{', '.join(SOURCES)}")
        texts[where[0]] = texts[where[0]].replace(old, new)
    for f, text in texts.items():
        (d / f).write_text(text)
    src = d / "hamming_sweep.cu"
    lib = d / "libhamming_sweep.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    (d / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).humid_hamming_sweep
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, i64, i32, i64, i32, p, p, i64, i32, i64, i64, i32, p,
                   i64, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def table_for(encoding: str, lanes):
    """The variant's table and its threshold function of max_dist."""
    import torch

    from ..ops import cuda_hamming as K
    from ..ops.hamming import onehot_bases

    n, w = lanes.shape
    if encoding == "simplex":
        return K.encode_table(lanes), lambda md: K.pass_threshold(w, md)
    rows = max(-(-n // K.TABLE_ROWS), 1) * K.TABLE_ROWS
    table = torch.zeros((rows, 64 * w), dtype=torch.int8,
                        device=lanes.device)
    table[:n] = onehot_bases(lanes, 16 * w, dtype=torch.int8)
    # matches over all 16 w slots; a pair passes iff matches >= 16 w - md.
    return table, lambda md: 16 * w - min(max(md, -1), 16 * w)


def run_shape(name, inp, fns, popc, rounds: int, reps: int) -> dict:
    import torch

    from ..ops import cuda_hamming as K
    from ..ops.neighbors import sweep_tensors

    dev = torch.device("cuda")
    lanes, tp = sweep_tensors(inp["rows"], inp["tile_pairs"], dev)
    ids = None if inp["ids"] is None else torch.from_numpy(
        inp["ids"]).to(dev)
    n, w = lanes.shape
    kw = {k: inp[k] for k in ("tile", "part_stride", "part_valid")}
    md = inp["max_dist"]
    want = K.hamming_tile_pairs_plain(lanes, tp, ids=ids, max_dist=md, **kw)
    want_keys = want[0] * n + want[1]
    keys = torch.empty(len(want_keys) + 1, dtype=torch.int64, device=dev)
    counter = torch.zeros(2, dtype=torch.int64, device=dev)
    work = torch.zeros(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ids_ptr = None if ids is None else ids.data_ptr()

    def launcher(variant):
        fn, encoding = fns[variant]
        table, thr = table_for(encoding, lanes)

        def run():
            counter.zero_()
            for lo in range(0, len(tp), K.CHUNK_PAIRS):
                chunk = tp[lo:lo + K.CHUNK_PAIRS]
                work.zero_()
                err = fn(table.data_ptr(), table.shape[0], table.shape[1], n,
                         w, ids_ptr, chunk.data_ptr(), len(chunk),
                         kw["tile"], kw["part_stride"], kw["part_valid"],
                         thr(md), keys.data_ptr(), len(keys),
                         counter.data_ptr(), work.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"{variant}: launch failed ({err})")
        return run

    def popc_run():
        counter.zero_()
        for lo in range(0, len(tp), K.CHUNK_PAIRS):
            chunk = tp[lo:lo + K.CHUNK_PAIRS]
            popc(lanes.data_ptr(), n, w, ids_ptr, chunk.data_ptr(),
                 len(chunk), kw["tile"], kw["part_stride"], kw["part_valid"],
                 md, keys.data_ptr(), len(keys), counter.data_ptr(), stream)

    runs = {v: launcher(v) for v in fns}
    for v, run in runs.items():
        run()
        torch.cuda.synchronize()
        got = torch.sort(keys[:int(counter[0])]).values
        if int(counter[0]) != len(want_keys) or not torch.equal(got,
                                                                want_keys):
            raise AssertionError(f"{name}: variant {v} differs from the "
                                 f"plain version")
    if popc is not None:
        runs["popc"] = popc_run
    order = list(runs)
    times = {v: [] for v in order}
    device = {v: [] for v in fns}
    launches = -(-len(tp) // K.CHUNK_PAIRS)
    for r in range(rounds):
        for v in (order if r % 2 == 0 else order[::-1]):
            times[v].append(time_cuda(runs[v], reps))
            if v in device:
                device[v].append(device_ms(runs[v], reps,
                                           "hamming_sweep", launches))
    out = {"shape": name, "w": w, "pairs": len(want_keys),
           "max_abs_err": 0, "rounds": rounds, "reps": reps,
           "kernel_ms": times, "device_ms": device}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--popc-src", type=Path)
    ap.add_argument("--parent-src", type=Path)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k1_variants needs a CUDA card", file=sys.stderr)
        return 1
    from .. import _build

    root = _build.BUILD_DIR / "k1_variants"
    jobs = [(v, None) for v in args.variants.split(",")]
    if args.parent_src is not None:
        jobs.append(("parent", args.parent_src.resolve()))
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        built = list(ex.map(lambda j: build_variant(j[0], root, j[1]), jobs))
    fns = {v: (fn, VARIANTS[v][0] if src is None else "simplex")
           for (v, src), fn in zip(jobs, built)}
    popc = None if args.popc_src is None else build_popc(
        args.popc_src.resolve(), _build.BUILD_DIR / "k1_compare")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    tables: dict = {}
    lines = [run_shape(s, shape_inputs(s, tables), fns, popc, args.rounds,
                       args.reps) for s in args.shapes.split(",")]
    print(smi, flush=True)
    if args.json:
        args.json.write_text("".join(json.dumps({**ln, "card": smi}) + "\n"
                                     for ln in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
