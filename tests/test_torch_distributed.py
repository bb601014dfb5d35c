"""The port's multi-process pipeline (humid_tpu_torch.parallel.pipeline)
against its single-process run() and the JAX package's run_distributed.

In-process, every simulated host runs ``run_distributed`` in a thread of
its own, and the gather and the barrier are a real rendezvous of those
threads (``_Rendezvous``): each host sends only what it computed.  The
JAX side runs with tests/simhosts.py, as tests/test_distributed_pipeline.py
runs it.  Then the CLI as 2 and 3 real processes over a gloo group on the
CPU.  Inputs come from tests/genfastq.py with fixed seeds; outputs are
compared byte for byte (gzip outputs by their decompressed bytes: the
member boundaries differ), labels exactly.
"""

import gzip
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from genfastq import gen_dataset  # noqa: E402
from simhosts import make_sim_gather  # noqa: E402

from humid_tpu.parallel import pipeline as JPP
from humid_tpu_torch import run
from humid_tpu_torch.io import make_file_names
from humid_tpu_torch.parallel import pipeline as PP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """One torch thread per op (several hosts share this process), and no
    routing variable from outside."""
    for var in ("HUMID_TPU_TORCH_STRATEGY", "HUMID_TPU_TORCH_CLUSTER_SHARDED",
                "HUMID_TPU_TORCH_SPAN_CACHE"):
        monkeypatch.delenv(var, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Rendezvous:
    """The gather and the barrier of ``n`` host threads."""

    def __init__(self, n):
        self.n = n
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=120)

    def gather_for(self, p):
        def gather(arrs):
            self.slots[p] = [np.array(a) for a in arrs]
            self.barrier.wait()
            out = [[self.slots[q][i] for q in range(self.n)]
                   for i in range(len(arrs))]
            self.barrier.wait()  # nobody sends again before all have read
            return out
        return gather


def _run_hosts(files, n_hosts, out_dir, **kw):
    """Every host's run_distributed, each in its own thread; returns their
    results in host order."""
    rv = _Rendezvous(n_hosts)
    results = [None] * n_hosts
    errors = []

    def host(p):
        try:
            results[p] = PP.run_distributed(
                files, dir_name=out_dir, log_name=os.devnull, process_id=p,
                num_processes=n_hosts, all_gather=rv.gather_for(p),
                barrier=rv.barrier.wait, device="cpu", **kw)
        except BaseException as exc:  # let the other hosts out
            errors.append(exc)
            rv.barrier.abort()

    threads = [threading.Thread(target=host, args=(p,))
               for p in range(n_hosts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors:
        raise errors[0]
    return results


def _run_reference_hosts(files, n_hosts, out_dir, **kw):
    """The JAX package's run_distributed, hosts in turn over simhosts."""
    from humid_tpu.io import make_file_names as j_names

    total = JPP.count_records(files)
    gather = make_sim_gather(files, total, n_hosts,
                             distance=kw.get("distance", 1),
                             edit=kw.get("edit", False),
                             maximum=kw.get("maximum", False))
    for p in range(n_hosts):
        JPP.run_distributed(files, dir_name=out_dir, log_name=os.devnull,
                            total_records=total, process_id=p,
                            num_processes=n_hosts, all_gather=gather,
                            barrier=lambda: None, finalize=False, **kw)
    names = []
    if kw.get("write_dedup", True):
        names += j_names(list(files), out_dir, "dedup")
    if kw.get("write_annotated", False):
        names += j_names(list(files), out_dir, "annotated")
    JPP.finalize_outputs(names, n_hosts)


def _read(path):
    with (gzip.open(path) if path.endswith(".gz") else open(path, "rb")) as f:
        return f.read()


def _same_dirs(d1, d2):
    n1, n2 = sorted(os.listdir(d1)), sorted(os.listdir(d2))
    assert n1 == n2
    for n in n1:
        assert _read(os.path.join(d1, n)) == _read(os.path.join(d2, n)), n


def _dataset(tmp_path, seed, n_reads, n_files=2, **kw):
    gen_dataset(np.random.default_rng(seed), str(tmp_path), n_reads=n_reads,
                n_files=n_files, **kw)
    gz = ".gz" if kw.get("gz") else ""
    return [str(tmp_path / f"file{i}.fastq{gz}") for i in range(n_files)]


@pytest.mark.parametrize("cluster", ["sharded", "replicated"])
@pytest.mark.parametrize("n_hosts", [2, 3])
def test_outputs_equal_single_process_and_reference(tmp_path, monkeypatch,
                                                    n_hosts, cluster):
    monkeypatch.setenv("HUMID_TPU_TORCH_CLUSTER_SHARDED",
                       "1" if cluster == "sharded" else "0")
    files = _dataset(tmp_path, 11, 700, umi_style="underscore")
    kw = dict(run_stats=True, write_annotated=True)
    ref = run(files, dir_name=str(tmp_path / "one"), log_name=os.devnull,
              device="cpu", **kw)
    results = _run_hosts(files, n_hosts, str(tmp_path / "dist"), **kw)
    _same_dirs(str(tmp_path / "one"), str(tmp_path / "dist"))
    assert PP.LAST_ENGINE["cluster"] == cluster
    for cl, counts, first_occ, uniq in results:
        np.testing.assert_array_equal(cl.labels, ref.labels)
        np.testing.assert_array_equal(counts, ref.counts)
    if cluster == "sharded":
        _run_reference_hosts(files, n_hosts, str(tmp_path / "jax"), **kw)
        _same_dirs(str(tmp_path / "jax"), str(tmp_path / "dist"))


@pytest.mark.parametrize("cluster", ["sharded", "replicated"])
def test_max_clustering_m2_gzip(tmp_path, monkeypatch, cluster):
    """-x at -m 2 over a gzip input through the range spill (3 hosts):
    decompressed outputs equal the single-process run's."""
    monkeypatch.setenv("HUMID_TPU_TORCH_CLUSTER_SHARDED",
                       "1" if cluster == "sharded" else "0")
    files = _dataset(tmp_path, 13, 600, n_files=1, umi_style="colon",
                     gz=True)
    spilled = []
    real = PP.spill_gz_ranges
    monkeypatch.setattr(PP, "spill_gz_ranges", lambda *a: (
        spilled.append(a[1:3]) or real(*a)))
    kw = dict(distance=2, maximum=True, write_annotated=True, run_stats=True)
    ref = run(files, dir_name=str(tmp_path / "one"), log_name=os.devnull,
              device="cpu", **kw)
    results = _run_hosts(files, 3, str(tmp_path / "dist"), **kw)
    _same_dirs(str(tmp_path / "one"), str(tmp_path / "dist"))
    assert sorted(spilled) == [(0, 200), (200, 400), (400, 600)]
    for cl, *_ in results:
        np.testing.assert_array_equal(cl.labels, ref.labels)


def test_gzip_spans_and_reference(tmp_path):
    """Two gzip files, dedup only, 3 hosts: the span writer runs on the
    spills; equal to the JAX package's run_distributed."""
    files = _dataset(tmp_path, 31, 700, umi_style="underscore", gz=True)
    run(files, dir_name=str(tmp_path / "one"), log_name=os.devnull,
        device="cpu")
    _run_hosts(files, 3, str(tmp_path / "dist"))
    _same_dirs(str(tmp_path / "one"), str(tmp_path / "dist"))
    _run_reference_hosts(files, 3, str(tmp_path / "jax"))
    _same_dirs(str(tmp_path / "jax"), str(tmp_path / "dist"))


@pytest.mark.parametrize("span_cache", ["1", "0"])
def test_edit(tmp_path, monkeypatch, span_cache):
    """-e over 2 hosts (the join cap agreed by gather): equal to the
    single-process run and the JAX package's run_distributed; with the
    span writers and with the re-reading range writers."""
    monkeypatch.setenv("HUMID_TPU_TORCH_SPAN_CACHE", span_cache)
    files = _dataset(tmp_path, 17, 400, n_files=1, umi_style="none",
                     ragged=True)
    kw = dict(edit=True, write_annotated=True, run_stats=True)
    run(files, dir_name=str(tmp_path / "one"), log_name=os.devnull,
        device="cpu", **kw)
    _run_hosts(files, 2, str(tmp_path / "dist"), **kw)
    _same_dirs(str(tmp_path / "one"), str(tmp_path / "dist"))
    assert PP.LAST_ENGINE["metric"] == "edit"
    _run_reference_hosts(files, 2, str(tmp_path / "jax"), **kw)
    _same_dirs(str(tmp_path / "jax"), str(tmp_path / "dist"))


def test_sharded_dedup_only_returns_full_labels(tmp_path, monkeypatch):
    """The reference's sharded cluster route returns empty labels when no
    annotated output is asked for; the port's returns all [U] of them."""
    monkeypatch.setenv("HUMID_TPU_TORCH_CLUSTER_SHARDED", "1")
    files = _dataset(tmp_path, 5, 500, n_files=1, umi_style="none")
    ref = run(files, dir_name=str(tmp_path / "one"), log_name=os.devnull,
              device="cpu")
    for cl, counts, first_occ, uniq in _run_hosts(files, 3,
                                                  str(tmp_path / "dist")):
        assert len(cl.labels) == len(uniq) == ref.unique
        np.testing.assert_array_equal(cl.labels, ref.labels)
    _same_dirs(str(tmp_path / "one"), str(tmp_path / "dist"))


def test_run_sharded_single_process(tmp_path):
    files = _dataset(tmp_path, 5, 300, n_files=1, umi_style="none")
    ref = run(files, dir_name=str(tmp_path / "one"), log_name=os.devnull,
              write_dedup=False, device="cpu")
    cl, counts, first_occ, uniq = PP.run_sharded(
        files, process_id=0, num_processes=1, device="cpu")
    np.testing.assert_array_equal(cl.labels, ref.labels)
    np.testing.assert_array_equal(counts, ref.counts)


def test_engine_broadcast_and_scaling_report(tmp_path, monkeypatch):
    """Process 0's router pick (a device engine here) is what every host
    runs, and the run records the scaling report of every host."""
    from humid_tpu_torch import _backend as B

    asked = []
    monkeypatch.setattr(B, "pick_neighbor_engine",
                        lambda dev, shardable_only=False: (
                            asked.append(shardable_only) or "runs_device"))
    files = _dataset(tmp_path, 41, 700, umi_style="underscore")
    kw = dict(write_annotated=True, run_stats=True)
    run(files, dir_name=str(tmp_path / "one"), log_name=os.devnull,
        device="cpu", **kw)
    _run_hosts(files, 3, str(tmp_path / "dist"), **kw)
    _same_dirs(str(tmp_path / "one"), str(tmp_path / "dist"))
    assert asked == [True]
    assert PP.LAST_ENGINE["strategy"] == "runs_device"
    rep = dict(PP.LAST_SCALING_REPORT)
    assert rep["n_hosts"] == 3 and len(rep["per_host_s"]) == 3
    assert 0.0 < rep["efficiency"] <= 1.0
    assert {"pack", "neighbors", "cluster", "write_dedup"} <= set(
        rep["phases"])


def test_uncoordinated_hosts_leave_parts(tmp_path):
    """Injected gathers and no barrier: the parts stay for an external
    finalize_outputs, which joins them into the single-process bytes."""
    files = _dataset(tmp_path, 9, 400, n_files=1, umi_style="none")
    run(files, dir_name=str(tmp_path / "one"), log_name=os.devnull,
        device="cpu")
    rv = _Rendezvous(2)
    out = str(tmp_path / "dist")
    threads = [threading.Thread(target=PP.run_distributed, args=(files,),
                                kwargs=dict(dir_name=out, log_name=os.devnull,
                                            process_id=p, num_processes=2,
                                            all_gather=rv.gather_for(p),
                                            device="cpu"))
               for p in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    names = make_file_names(files, out, "dedup")
    assert sorted(os.listdir(out)) == sorted(
        os.path.basename(n) + f".part{p:05d}" for n in names for p in (0, 1))
    PP.finalize_outputs(names, 2)
    _same_dirs(str(tmp_path / "one"), out)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_env():
    env = dict(os.environ, HUMID_TPU_TORCH_DEVICE="cpu",
               HUMID_TPU_TORCH_SCALING_REPORT="1", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _cli(args, **kw):
    return subprocess.Popen([sys.executable, "-m", "humid_tpu_torch", *args],
                            env=_cli_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, **kw)


@pytest.mark.parametrize("n_proc,gz", [(2, False), (3, False), (2, True)],
                         ids=["2", "3", "2_gzip"])
def test_cli_processes_over_gloo(tmp_path, n_proc, gz):
    """The CLI as real processes in a gloo group on the CPU: the outputs
    are the single-process CLI's bytes (gzip: decompressed; there the
    range spill waits at the rendezvous store's barrier), and process 0
    prints the report."""
    import json

    files = _dataset(tmp_path, 21, 500, umi_style="underscore", gz=gz)
    flags = ["-s", "-a", "-l", os.devnull]
    one = _cli([*flags, "-d", str(tmp_path / "one"), *files])
    port = _free_port()
    procs = [_cli(["--coordinator", f"127.0.0.1:{port}", "--num-processes",
                   str(n_proc), "--process-id", str(p), *flags, "-d",
                   str(tmp_path / "dist"), *files])
             for p in range(n_proc)]
    outs = []
    try:
        for p in [one, *procs]:
            outs.append((p.returncode, *p.communicate(timeout=120)))
    finally:
        for p in [one, *procs]:
            p.kill()
    for p, (_, out, err) in zip([one, *procs], outs):
        assert p.returncode == 0, err.decode()[-2000:]
    _same_dirs(str(tmp_path / "one"), str(tmp_path / "dist"))
    line = next(ln for ln in outs[1][2].decode().splitlines()
                if ln.startswith("humid_tpu_torch scaling report:"))
    assert json.loads(line.split(":", 1)[1])["n_hosts"] == n_proc


@pytest.mark.parametrize("args,message", [
    (["--num-processes", "2"], "requires --coordinator"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2"],
     "--process-id"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "2"], "is not in"),
    (["--coordinator", "nohostport", "--num-processes", "1",
      "--process-id", "0"], "HOST:PORT")])
def test_cli_bad_configuration_is_a_usage_error(tmp_path, args, message):
    p = _cli([*args, str(tmp_path / "missing.fastq")])
    _, err = p.communicate(timeout=60)
    assert p.returncode == 2
    assert message in err.decode() and "Traceback" not in err.decode()
