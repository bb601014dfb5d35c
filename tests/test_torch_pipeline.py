"""End-to-end tests of the port's CLI (python -m humid_tpu_torch) on the
CPU: byte-identical outputs to the independent C++ baseline
(baseline/humid_ref) on every golden case of test_golden.py (Hamming and
edit distance) and on its 20k-read edit case, and to the JAX package's
CLI on four of them.

Datasets are made from fixed seeds and fed to every implementation.
Outputs are bytes, so every comparison is exact equality (the log after
normalising its wall-clock times).
"""

import os
import re
import shutil
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from genfastq import gen_dataset  # noqa: E402
from test_golden import CASES, _read  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HAMMING_CASES = [c for c in CASES if "-e" not in c[4]]
HAMMING_IDS = ["single", "paired_umi", "colon_gz", "threefile", "m2", "max",
               "m0", "m3", "n16", "n80", "n0", "ragged_n", "unequal",
               "word_gt_read", "max_m2_ragged"]
EDIT_CASES = [c for c in CASES if "-e" in c[4]]
EDIT_IDS = ["edit", "edit_max_ragged", "edit_m2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tables here are tiny, and several test processes share the
    machine's cores: with a full thread pool in each, every small CPU op
    waits for threads that are not scheduled.  One thread per op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture
def cpu_device(monkeypatch):
    monkeypatch.setenv("HUMID_TPU_TORCH_DEVICE", "cpu")


def _dataset(case, tmp_path):
    n_reads, n_files, umi_style, gz, extra, gen_kw = case
    rng = np.random.default_rng(zlib.crc32(str(case).encode()))
    data = tmp_path / "data"
    data.mkdir()
    gen_dataset(rng, str(data), n_reads=n_reads, n_files=n_files,
                umi_style=umi_style, gz=gz, **gen_kw)
    ext = "fastq.gz" if gz else "fastq"
    return [str(data / f"file{i}.{ext}") for i in range(n_files)], extra


def _run_ref(exe, out, flags, files):
    out.mkdir()
    subprocess.run([exe, "-d", str(out), *flags, *files], check=True,
                   capture_output=True)


def _run_port(out, flags, files):
    from humid_tpu_torch.cli import main

    out.mkdir()
    assert main(["-d", str(out), "-l", os.devnull, *flags, *files]) == 0


def _assert_same_dirs(d1, d2):
    names = sorted(os.listdir(d1))
    assert names == sorted(os.listdir(d2))
    for name in names:
        assert _read(d1 / name) == _read(d2 / name), name


@pytest.mark.parametrize("case", HAMMING_CASES + EDIT_CASES,
                         ids=HAMMING_IDS + EDIT_IDS)
def test_cli_matches_humid_ref(case, humid_ref, cpu_device, tmp_path):
    files, extra = _dataset(case, tmp_path)
    _run_ref(humid_ref, tmp_path / "ref", ["-s", "-a", *extra], files)
    _run_port(tmp_path / "port", ["-s", "-a", *extra], files)
    _assert_same_dirs(tmp_path / "ref", tmp_path / "port")


@pytest.mark.parametrize(
    "case", [HAMMING_CASES[i] for i in (0, 1, 5)] + EDIT_CASES[:1],
    ids=["single", "paired_umi", "max", "edit"])
def test_cli_matches_humid_tpu(case, cpu_device, tmp_path):
    from humid_tpu.cli import main as ref_main

    files, extra = _dataset(case, tmp_path)
    (tmp_path / "jax").mkdir()
    ref_main(["-d", str(tmp_path / "jax"), "-s", "-a", "-l", os.devnull,
              *extra, *files])
    _run_port(tmp_path / "port", ["-s", "-a", *extra], files)
    _assert_same_dirs(tmp_path / "jax", tmp_path / "port")


def test_log_structure(humid_ref, cpu_device, tmp_path):
    """The -l log matches the reference's line for line with the (XmYs)
    timings normalised (as test_golden.test_golden_log_structure)."""
    from humid_tpu_torch.cli import main

    gen_dataset(np.random.default_rng(55), str(tmp_path), n_reads=300,
                n_files=2, umi_style="underscore")
    files = [str(tmp_path / f"file{i}.fastq") for i in range(2)]
    (tmp_path / "ref").mkdir()
    log_ref = str(tmp_path / "ref.log")
    log_port = str(tmp_path / "port.log")
    subprocess.run([humid_ref, "-d", str(tmp_path / "ref"), "-s", "-a",
                    "-l", log_ref, *files], check=True, capture_output=True)
    main(["-d", str(tmp_path / "port"), "-s", "-a", "-l", log_port, *files])
    norm = lambda p: re.sub(r"\(\d+m\d+s\)", "(XmYs)", open(p).read())
    assert norm(log_ref) == norm(log_port)


def test_span_cache_writer(humid_ref, cpu_device, tmp_path, monkeypatch):
    """HUMID_TPU_TORCH_SPAN_CACHE=1 forces the span-based writers; the
    outputs stay byte-identical, including a final record without its
    trailing newline."""
    gen_dataset(np.random.default_rng(66), str(tmp_path), n_reads=400,
                n_files=2, umi_style="underscore", ragged=True)
    files = [str(tmp_path / f"file{i}.fastq") for i in range(2)]
    raw = open(files[1], "rb").read()
    open(files[1], "wb").write(raw[:-1])
    _run_ref(humid_ref, tmp_path / "ref", ["-s", "-a"], files)
    monkeypatch.setenv("HUMID_TPU_TORCH_SPAN_CACHE", "1")
    _run_port(tmp_path / "port", ["-s", "-a"], files)
    _assert_same_dirs(tmp_path / "ref", tmp_path / "port")


def test_import_and_run_leave_jax_out(tmp_path):
    """The port imports torch and never jax, also through a whole run."""
    gen_dataset(np.random.default_rng(1), str(tmp_path), n_reads=50)
    code = (
        "import sys\n"
        "import humid_tpu_torch\n"
        "from humid_tpu_torch.cli import main\n"
        f"assert main(['-d', {str(tmp_path / 'o')!r}, '-s', '-l', "
        f"'/dev/null', {str(tmp_path / 'file0.fastq')!r}]) == 0\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(m.startswith('humid_tpu.') or m == 'humid_tpu'\n"
        "               for m in sys.modules), 'humid_tpu imported'\n")
    env = dict(os.environ, HUMID_TPU_TORCH_DEVICE="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(tmp_path))
    assert (tmp_path / "o" / "stats.dat").exists()


def test_cuda_request_without_cuda_raises(tmp_path, monkeypatch, capsys):
    import humid_tpu_torch
    from humid_tpu_torch.cli import main
    from humid_tpu_torch.errors import DeviceUnavailableError

    gen_dataset(np.random.default_rng(2), str(tmp_path), n_reads=20)
    fq = str(tmp_path / "file0.fastq")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="HUMID_TPU_TORCH_DEVICE"):
        humid_tpu_torch.run([fq], dir_name=str(tmp_path / "o"),
                            log_name=os.devnull, device="cuda")
    monkeypatch.delenv("HUMID_TPU_TORCH_DEVICE", raising=False)
    assert main(["-d", str(tmp_path / "o"), "-l", os.devnull, fq]) == 1
    assert "HUMID_TPU_TORCH_DEVICE" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()  # failed before any output


@pytest.mark.parametrize("flags,message", [
    (["--coordinator", "127.0.0.1:1234"], "--process-id"),
    (["--num-processes", "2"], "requires --coordinator")],
    ids=["coordinator", "num_processes"])
def test_incomplete_multiprocess_flags_are_usage_errors(flags, message,
                                                        tmp_path, capsys):
    """An incomplete multi-process configuration is a usage error: status
    2, no traceback, nothing written."""
    from humid_tpu_torch.cli import main

    with pytest.raises(SystemExit) as exc:
        main([*flags, "-d", str(tmp_path / "o"), str(tmp_path / "x.fq")])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert message in err and "Traceback" not in err
    assert not (tmp_path / "o").exists()


def test_process_id_alone_runs_one_process(tmp_path, capsys):
    """``--process-id`` alone names no multi-process run, so the run is
    single-process (the JAX CLI's rule): its missing input is an input
    error, status 1, with no traceback and nothing written."""
    from humid_tpu_torch.cli import main

    assert main(["--process-id", "0", "-d", str(tmp_path / "o"),
                 str(tmp_path / "x.fq")]) == 1
    err = capsys.readouterr().err
    assert "humid-tpu-torch: error:" in err and "Traceback" not in err
    assert not (tmp_path / "o").exists()


@pytest.fixture(scope="module")
def midscale_edit(humid_ref, tmp_path_factory):
    """The 20k-read edit case of test_golden.py (60 bp reads from the
    benchmark recipe) and humid_ref's ``-s -e`` outputs on it."""
    sys.path.insert(0, REPO)
    import bench

    root = tmp_path_factory.mktemp("midscale_edit")
    fq = str(root / "edit.fastq")
    bench.gen_dataset(fq, 20_000, read_len=60, seed=5)
    _run_ref(humid_ref, root / "ref", ["-s", "-e"], [fq])
    return fq, root / "ref"


@pytest.mark.parametrize("opts,engine", [
    ({}, {"unique": "host", "metric": "edit", "strategy": "runs",
          "join_cap_fallbacks": 0, "umi_native_rows": 0}),
    ({"strategy": "sharded", "mesh": 3},
     {"unique": "host", "metric": "edit", "strategy": "sharded", "shards": 3,
      "ring_fallbacks": 0, "join_cap_fallbacks": 0, "umi_native_rows": 0}),
    ({"strategy": "dense"}, {"unique": "host", "metric": "edit",
                             "strategy": "dense", "umi_native_rows": 0}),
], ids=["auto", "sharded", "dense"])
def test_midscale_edit_matches_humid_ref(opts, engine, midscale_edit,
                                         tmp_path):
    """Above 2,048 uniques auto takes the shifted-segment search and
    ``sharded`` the shifted mesh search; every engine writes humid_ref's
    bytes."""
    import humid_tpu_torch
    from humid_tpu_torch.parallel import data_mesh

    fq, ref = midscale_edit
    if "mesh" in opts:
        opts = {**opts, "mesh": data_mesh(opts["mesh"], "cpu")}
    res = humid_tpu_torch.run([fq], dir_name=str(tmp_path / "port"),
                              log_name=os.devnull, run_stats=True, edit=True,
                              device="cpu", neighbor_opts=opts)
    assert res.unique > 2048
    got = dict(res.extra["engine"])
    candidates = got.pop("candidates", 1)
    assert candidates > 0
    if got["strategy"] == "runs":
        # The shifted search's counters, which depend on the data: the
        # pairs it kept, the DP's batches of 2^20 distinct candidates,
        # and the candidates an earlier join had found.
        assert got.pop("edit_pairs") == int(res.degree.sum()) // 2
        distinct = got.pop("distinct_candidates")
        assert got.pop("verify_batches") == -(-distinct // (1 << 20))
        assert candidates - got.pop("first_join_dropped") == distinct
    assert got == engine
    assert "Calculating neighbours using Levenshtein distance" in \
        res.extra["timings"]
    _assert_same_dirs(ref, tmp_path / "port")


def test_edit_and_hamming_differ_on_indels(humid_ref, tmp_path):
    """Reads whose words have copies shifted by one base: at -m 2 the -e
    run joins clusters that the Hamming run keeps apart, and each run
    writes humid_ref's bytes for its own flags (a -e that computed the
    Hamming distance would pass every equal-length m = 1 case)."""
    import humid_tpu_torch

    rng = np.random.default_rng(77)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pool = bases[rng.integers(0, 4, (300, 30))]
    shifted = pool[::3].copy()
    shifted[:, 1:] = pool[::3, :-1]
    shifted[:, 0] = bases[rng.integers(0, 4, len(shifted))]
    words = np.concatenate([pool, shifted])
    seqs = words[rng.integers(0, len(words), 1500)]
    fq = tmp_path / "indels.fastq"
    with open(fq, "wb") as f:
        for i, seq in enumerate(seqs):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(), b"I" * 30))
    clusters = {}
    for name, flags in (("hamming", []), ("edit", ["-e"])):
        _run_ref(humid_ref, tmp_path / f"ref_{name}",
                 ["-n", "30", "-m", "2", "-s", "-a", *flags], [str(fq)])
        res = humid_tpu_torch.run(
            [str(fq)], word_length=30, distance=2, edit=bool(flags),
            dir_name=str(tmp_path / name), log_name=os.devnull,
            run_stats=True, write_annotated=True, device="cpu")
        assert res.extra["engine"]["metric"] == name
        _assert_same_dirs(tmp_path / f"ref_{name}", tmp_path / name)
        clusters[name] = res.clusters
    assert clusters["edit"] < clusters["hamming"]


def test_edit_log_names_levenshtein(humid_ref, cpu_device, tmp_path):
    """The -l log of an -e run matches the reference's line for line."""
    from humid_tpu_torch.cli import main

    gen_dataset(np.random.default_rng(56), str(tmp_path), n_reads=200)
    fq = str(tmp_path / "file0.fastq")
    (tmp_path / "ref").mkdir()
    subprocess.run([humid_ref, "-d", str(tmp_path / "ref"), "-e", "-l",
                    str(tmp_path / "ref.log"), fq], check=True,
                   capture_output=True)
    assert main(["-d", str(tmp_path / "port"), "-e", "-l",
                 str(tmp_path / "port.log"), fq]) == 0
    norm = lambda p: re.sub(r"\(\d+m\d+s\)", "(XmYs)", open(p).read())
    assert norm(tmp_path / "ref.log") == norm(tmp_path / "port.log")
    assert "Levenshtein" in norm(tmp_path / "port.log")


def test_mesh_strategies_write_the_same_bytes(tmp_path):
    """run() through the ring on 3 shards and through the bucketed mesh
    search writes the bytes of the default route and of the JAX package's
    run() through its Pallas ring."""
    import humid_tpu
    import humid_tpu_torch
    from humid_tpu_torch import pipeline
    from humid_tpu_torch.parallel import data_mesh

    files, extra = _dataset(HAMMING_CASES[1], tmp_path)  # paired, with UMI
    assert extra == []
    kw = dict(log_name=os.devnull, run_stats=True, write_annotated=True)
    humid_tpu.run(files, dir_name=str(tmp_path / "jax"),
                  neighbor_opts={"strategy": "pallas_ring"}, **kw)
    humid_tpu_torch.run(files, dir_name=str(tmp_path / "auto"),
                        device="cpu", **kw)
    mesh = data_mesh(3, "cpu")
    for strategy in ("ring", "sharded_bucketed"):
        res = humid_tpu_torch.run(
            files, dir_name=str(tmp_path / strategy), device="cpu",
            neighbor_opts={"strategy": strategy, "mesh": mesh}, **kw)
        # Every read's UMI comes from the native parse where it is built.
        native = (pipeline._gather_umi is not None
                  and pipeline._encode_pack is not None)
        assert res.extra["engine"] == {
            "unique": "host", "metric": "hamming", "strategy": strategy,
            "shards": 3, "ring_fallbacks": 0,
            "umi_native_rows": res.total if native else 0}
        _assert_same_dirs(tmp_path / "auto", tmp_path / strategy)
        _assert_same_dirs(tmp_path / "jax", tmp_path / strategy)


def test_cli_honours_strategy_and_shards_variables(humid_ref, cpu_device,
                                                   tmp_path, monkeypatch):
    from humid_tpu_torch import cli, pipeline

    files, extra = _dataset(HAMMING_CASES[0], tmp_path)
    _run_ref(humid_ref, tmp_path / "ref", ["-s", "-a", *extra], files)
    monkeypatch.setenv("HUMID_TPU_TORCH_STRATEGY", "ring")
    monkeypatch.setenv("HUMID_TPU_TORCH_SHARDS", "4")
    results = []
    monkeypatch.setattr(
        cli, "run", lambda *a, **k: results.append(pipeline.run(*a, **k)))
    _run_port(tmp_path / "port", ["-s", "-a", *extra], files)
    assert [r.extra["engine"] for r in results] == [
        {"unique": "host", "metric": "hamming", "strategy": "ring",
         "shards": 4, "ring_fallbacks": 0, "umi_native_rows": 0}]
    _assert_same_dirs(tmp_path / "ref", tmp_path / "port")
