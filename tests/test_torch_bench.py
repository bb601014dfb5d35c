"""The port's bench (humid_tpu_torch.tools.bench) on the CPU: its dataset
against the JAX package's bench.py, its stop rule on made-up sample
times, a whole bench run against baseline/humid_ref's output, and the
imports it makes.

Datasets and outputs are bytes, sample counts integers: every comparison
is exact equality.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

from humid_tpu_torch import _backend
from humid_tpu_torch.tools import bench as B

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: bench.py's keys in its order (bench.py:326-351), then the port's three.
KEYS = ["metric", "value", "unit", "vs_baseline", "baseline_reads_per_sec",
        "backend", "engine", "n_runs", "value_median", "steal_factor",
        "tunnel_factor", "phases", "phases_best", "baseline_source", "card",
        "host_extensions"]


@pytest.fixture(scope="module")
def root_bench():
    """The JAX package's bench.py (numpy only at module level)."""
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def humid_ref(tmp_path_factory):
    """baseline/humid_ref built into this module's own temporary dir."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    exe = str(tmp_path_factory.mktemp("humid_ref") / "humid_ref")
    subprocess.run([gxx, "-O2", "-std=c++17", "-o", exe,
                    os.path.join(REPO, "baseline", "humid_ref.cpp"), "-lz"],
                   check=True)
    return exe


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("n_reads", [4096, 10_001])
def test_gen_dataset_matches_bench_py(n_reads, seed, root_bench, tmp_path):
    B.gen_dataset(str(tmp_path / "port.fastq"), n_reads, seed=seed)
    root_bench.gen_dataset(str(tmp_path / "jax.fastq"), n_reads, seed=seed)
    port = (tmp_path / "port.fastq").read_bytes()
    assert port == (tmp_path / "jax.fastq").read_bytes()
    assert port.count(b"\n") == 4 * n_reads


def _stop(samples, micro, elapsed=lambda n: 0.0, budget=100.0):
    """The number of runs after which the sampler stops, or None."""
    for n in range(1, len(samples) + 1):
        if B.sampling_done(samples[:n], micro[:n + 1], elapsed(n), budget):
            return n
    return None


@pytest.mark.parametrize("samples,stop", [
    ([1.0] * 20, 7),
    # within 2% of the best is no improvement
    ([1.0 - 0.01 * i for i in range(20)], 7),
    # an improvement of more than 2% starts the count again
    ([1.0 - 0.05 * i for i in range(10)] + [0.55] * 10, 14),
    ([1.0, 1.0, 1.0, 1.0, 1.0, 0.9, 1.0, 1.0, 1.0, 1.0, 1.0], 10),
], ids=["flat", "creeping", "improving_then_flat", "late_improvement"])
def test_sampler_converges_after_four_without_improvement(samples, stop):
    assert _stop(samples, [1.0] * (len(samples) + 1)) == stop


def test_sampler_stops_at_three_runs_over_budget():
    samples = [1.0 - 0.1 * i for i in range(8)]  # improving: no convergence
    assert _stop(samples, [1.0] * 9) is None
    over = lambda n: 200.0  # every check is past the budget
    assert _stop(samples, [1.0] * 9, elapsed=over) == 3
    # Under budget until the fifth run.
    assert _stop(samples, [1.0] * 9, elapsed=lambda n: 10.0 * n,
                 budget=45.0) == 5


def test_sampler_does_not_count_noisy_samples():
    samples = [1.0] * 12
    quiet = [1.0] * 13
    assert _stop(samples, quiet) == 7
    # Runs 2-4 read a probe 2x the quickest: they do not count.
    noisy = [1.0, 1.0, 2.0, 2.0, 2.0] + [1.0] * 8
    assert _stop(samples, noisy) == 8
    # 1.5x is still quiet.
    assert _stop(samples, [1.0, 1.0, 1.5, 1.5, 1.5] + [1.0] * 8) == 7


def test_baseline_estimate_without_humid_ref(tmp_path):
    fq = str(tmp_path / "r.fastq")
    B.gen_dataset(fq, 64)
    rps, source = B.measure_baseline(
        fq, 64, 1, str(tmp_path / "out_ref"), exe=str(tmp_path / "none"),
        src=str(tmp_path / "missing.cpp"))
    assert (rps, source) == (B.BASELINE_READS_PER_SEC, "estimate")


def test_bench_on_cpu_matches_humid_ref(humid_ref, tmp_path, monkeypatch,
                                       capsys):
    """A whole bench on the CPU: one JSON line with bench.py's keys in
    order and the port's three, and dedup bytes equal to humid_ref's on
    the same file with the same flags."""
    monkeypatch.setenv("HUMID_TPU_TORCH_DEVICE", "cpu")
    n = 4096
    record = B.bench(n, work_dir=str(tmp_path), budget=0.0,
                     humid_ref=humid_ref)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    printed = json.loads(lines[0])
    assert printed == record and list(printed) == KEYS
    assert printed["metric"] == "reads_per_sec" and printed["value"] > 0
    assert printed["backend"] == "cpu" and printed["card"] is None
    assert printed["engine"] is not None
    assert printed["n_runs"] == 3  # over its budget of 0 s
    assert printed["baseline_source"] == "humid_ref"
    assert printed["tunnel_factor"] is None
    assert printed["vs_baseline"] > 0 and printed["phases"]
    assert printed["host_extensions"] == dict(zip(
        B.EXTENSIONS, (f == "1" for f in _backend._host_extensions())))
    name = f"bench_{n}_dedup.fastq"
    assert sorted(os.listdir(tmp_path / "out_ref")) == [name]
    port = (tmp_path / "out" / name).read_bytes()
    assert port == (tmp_path / "out_ref" / name).read_bytes()
    assert port.count(b"\n") > 0


def test_bench_leaves_jax_and_bench_py_out(humid_ref, tmp_path):
    """The bench imports torch and never jax, the JAX package or the root
    bench.py, also through a whole bench."""
    code = (
        "import sys\n"
        "from humid_tpu_torch.tools import bench\n"
        f"bench.bench(2048, work_dir={str(tmp_path)!r}, budget=0.0, "
        f"humid_ref={humid_ref!r})\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'bench' not in sys.modules, 'bench.py imported'\n"
        "assert not any(m.startswith('humid_tpu.') or m == 'humid_tpu'\n"
        "               for m in sys.modules), 'humid_tpu imported'\n")
    env = dict(os.environ, HUMID_TPU_TORCH_DEVICE="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.splitlines()[-1])["value"] > 0
