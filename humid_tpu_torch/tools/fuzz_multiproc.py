"""Randomized multi-process fuzz: random flag and dataset configs run as
real CLI processes of one ``torch.distributed`` group and byte-compared
with the single-process run.

    python -m humid_tpu_torch.tools.fuzz_multiproc [n_configs] [start_seed]
                                                   [--device D]

Counterpart of the JAX package's ``scripts/fuzz_multiproc.py``, with its
draw call for call (defaults: 20 configs from seed 42,000): 1-3 files,
2-3 processes, ``-e`` one time in five, 60-400 reads, UMI styles, gzip,
ragged reads, unequal files, ``-m 0-2``, ``-n 8-32``, ``-x``, and the
distributed cluster route (HUMID_TPU_TORCH_CLUSTER_SHARDED=1 forces the
owned-component walks and their merge, 0 the replicated walk).  Each
config runs ``python -m humid_tpu_torch --coordinator 127.0.0.1:<free
port> --num-processes n --process-id p`` once per process, all started
together (a gloo group on the CPU and on a card alike), and every output
file must equal, byte for byte, what the port's in-process ``run()``
writes for the same flags (gzip outputs after decompression: the part
files' member boundaries differ).  Each process has 300 s; on a timeout
every process is killed and the config fails.

The device is ``resolve_device()``'s (CUDA unless ``--device cpu`` or
HUMID_TPU_TORCH_DEVICE=cpu; without a card it raises), for the
in-process run and every process alike.  The last line of the output is
one JSON summary: configs, failures, seconds per config.  Exits 1 if any
config differs or fails.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

from .._device import resolve_device
from ..pipeline import run
from .fuzz_oracle import REPO, _testing_helpers

#: Seconds one process may take.
PROCESS_TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read(path: str) -> bytes:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def draw_config(rng: np.random.Generator) -> tuple[dict, list, int, bool]:
    """The reference's draw up to the dataset (scripts/fuzz_multiproc.py
    ``run_one``), call for call: (gen_dataset keywords, CLI flags, number
    of processes, edit)."""
    n_files = int(rng.integers(1, 4))
    n_proc = int(rng.integers(2, 4))
    edit = bool(rng.integers(0, 5) == 0)
    cfg = dict(
        n_reads=int(rng.integers(60, 400)),
        n_files=n_files,
        umi_style=["none", "underscore", "colon"][int(rng.integers(0, 3))],
        gz=bool(rng.integers(0, 2)),
        ragged=bool(rng.integers(0, 2)),
        unequal_lengths=bool(rng.integers(0, 2)) and n_files > 1,
    )
    flags = ["-m", str(int(rng.integers(0, 3))),
             "-n", str(int(rng.integers(8, 33)))]
    if edit:
        flags.append("-e")
    if rng.integers(0, 2):
        flags.append("-x")
    return cfg, flags, n_proc, edit


def run_one(seed: int, device) -> dict:
    """One config: the dataset, the in-process run, the processes, the
    comparison.  Returns the config; raises on a difference, a failed
    process or a timeout."""
    gen_dataset, _, _ = _testing_helpers()
    rng = np.random.default_rng(seed)
    cfg, flags, n_proc, edit = draw_config(rng)
    with tempfile.TemporaryDirectory() as d:
        gen_dataset(rng, d, **cfg)
        ext = "fastq.gz" if cfg["gz"] else "fastq"
        files = [os.path.join(d, f"file{i}.{ext}")
                 for i in range(cfg["n_files"])]
        ref_dir = os.path.join(d, "ref")
        run(files, dir_name=ref_dir, log_name=os.devnull, write_dedup=True,
            write_annotated=True, run_stats=True, edit=edit,
            maximum="-x" in flags, distance=int(flags[1]),
            word_length=int(flags[3]), device=device)

        cfg["cluster_sharded"] = bool(rng.integers(0, 2))
        env = dict(os.environ, HUMID_TPU_TORCH_DEVICE=str(device),
                   HUMID_TPU_TORCH_CLUSTER_SHARDED=(
                       "1" if cfg["cluster_sharded"] else "0"))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (REPO, env.get("PYTHONPATH")) if p)
        out_dir = os.path.join(d, "dist")
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "humid_tpu_torch",
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(n_proc), "--process-id", str(pid),
             "-d", out_dir, "-s", "-a", "-l", os.devnull, *flags, *files],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for pid in range(n_proc)]
        try:
            for pid, p in enumerate(procs):
                try:
                    _, err = p.communicate(timeout=PROCESS_TIMEOUT)
                except subprocess.TimeoutExpired:
                    raise RuntimeError(
                        f"process {pid} of {n_proc} timed out after "
                        f"{PROCESS_TIMEOUT} s") from None
                if p.returncode != 0:
                    raise RuntimeError(
                        f"process {pid} of {n_proc} exited {p.returncode}: "
                        f"{err.decode(errors='replace')[-1500:]}")
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for f in sorted(os.listdir(ref_dir)):
            if _read(os.path.join(ref_dir, f)) != _read(
                    os.path.join(out_dir, f)):
                raise AssertionError(f"{f} differs (n_proc={n_proc})")
    return dict(cfg, flags=flags, n_proc=n_proc)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_configs", type=int, nargs="?", default=20)
    p.add_argument("start_seed", type=int, nargs="?", default=42_000)
    p.add_argument("--device", default=None,
                   help="cuda (default, or $HUMID_TPU_TORCH_DEVICE) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    t_all = time.perf_counter()
    failures, seconds = [], []
    for i in range(args.n_configs):
        seed = args.start_seed + i
        t0 = time.perf_counter()
        try:
            cfg = run_one(seed, device)
            status = "ok"
        except Exception:
            failures.append((seed, traceback.format_exc()))
            status, cfg = "FAIL", {}
        seconds.append(time.perf_counter() - t0)
        print(f"[{i + 1}/{args.n_configs}] seed={seed} {status} "
              f"{seconds[-1]:.3f} s {json.dumps(cfg)}", flush=True)
    for seed, tb in failures:
        print(f"--- seed={seed}\n{tb}", flush=True)
    if not failures:
        print(f"all {args.n_configs} multi-process configs byte-match the "
              f"single-process run")
    print(json.dumps({"configs": args.n_configs, "failures": len(failures),
                      "failed_seeds": [s for s, _ in failures],
                      "device": str(device), "seconds_per_config": seconds,
                      "seconds": time.perf_counter() - t_all}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
