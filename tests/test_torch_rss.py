"""Resident memory of one process across repeated runs, for the JAX
package's ``humid_tpu.run`` beside the port's ``tools/bench.py`` loop.

    JAX_PLATFORMS=cpu python tests/test_torch_rss.py [--reads N] [--runs R]

runs ``humid_tpu.run`` R times (default 50) in this process on the
bench's dataset of N reads (default 250,000; ``tools.bench.gen_dataset``,
bench.py's recipe) with bench.py's flags (distance 1, dedup output only)
and prints one JSON line: the resident set (MiB, /proc) after each run.
The port's curve on the same file comes from
``HUMID_TPU_TORCH_DEVICE=cpu python -m humid_tpu_torch.tools.bench
--reads N --runs R`` (its "memory per timed run" note), and on a card
from the same command without the variable.  The tests below run both
loops for a few runs at a tiny size, so that neither script rots.
"""

import argparse
import json
import os
import sys
import tempfile

if __name__ == "__main__":  # run as a script from the repo's root
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from humid_tpu_torch.tools import bench as B  # noqa: E402


def reference_rss_curve(fastq: str, out_dir: str, runs: int) -> list:
    """``humid_tpu.run`` ``runs`` times on ``fastq`` with bench.py's flags;
    the resident set (MiB) after each run."""
    import humid_tpu

    curve = []
    for _ in range(runs):
        humid_tpu.run([fastq], distance=1, write_dedup=True,
                      dir_name=out_dir, log_name=os.devnull)
        curve.append(B.rss_mib())
    return curve


def _dataset(work: str, n_reads: int) -> str:
    fq = os.path.join(work, f"bench_{n_reads}.fastq")
    if not os.path.exists(fq):
        B.gen_dataset(fq, n_reads)
    return fq


def test_reference_rss_curve(tmp_path):
    fq = _dataset(str(tmp_path), 2000)
    curve = reference_rss_curve(fq, str(tmp_path / "out"), 3)
    assert len(curve) == 3 and all(v > 0 for v in curve)


def test_port_bench_fixed_runs(tmp_path, capsys, monkeypatch):
    """``bench --runs R`` takes exactly R timed runs and reports R memory
    samples (the port's side of the curve)."""
    monkeypatch.setattr(B, "measure_baseline",
                        lambda *a, **k: (1.0, "estimate"))
    rec = B.bench(2000, warmup=False, work_dir=str(tmp_path), budget=0.0,
                  device="cpu", runs=4)
    assert rec["n_runs"] == 4
    notes = capsys.readouterr().err
    memory = json.loads(notes.split("# memory per timed run: ")[1]
                        .splitlines()[0])
    assert len(memory["rss_mib"]) == 4


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reads", type=int, default=250_000)
    p.add_argument("--runs", type=int, default=50)
    args = p.parse_args(argv)
    work = os.path.join(tempfile.gettempdir(), "humid_tpu_torch_bench")
    os.makedirs(work, exist_ok=True)
    fq = _dataset(work, args.reads)
    curve = reference_rss_curve(fq, os.path.join(work, "out_jax"), args.runs)
    print(json.dumps({"package": "humid_tpu", "reads": args.reads,
                      "runs": args.runs, "rss_mib": curve}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
