"""End-to-end tests of the port's CLI (python -m humid_tpu_torch) on the
CPU: byte-identical outputs to the independent C++ baseline
(baseline/humid_ref) on every Hamming-distance golden case of
test_golden.py, and to the JAX package's CLI on three of them.

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

# The golden cases without edit distance (-e is not yet ported).
HAMMING_CASES = [c for c in CASES if "-e" not in c[4]]
HAMMING_IDS = ["single", "paired_umi", "colon_gz", "threefile", "m2", "max",
               "m0", "m3", "n16", "n80", "n0", "ragged_n", "unequal",
               "word_gt_read", "max_m2_ragged"]


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


@pytest.mark.parametrize("case", HAMMING_CASES, ids=HAMMING_IDS)
def test_cli_matches_humid_ref(case, humid_ref, cpu_device, tmp_path):
    files, extra = _dataset(case, tmp_path)
    _run_ref(humid_ref, tmp_path / "ref", ["-s", "-a", *extra], files)
    _run_port(tmp_path / "port", ["-s", "-a", *extra], files)
    _assert_same_dirs(tmp_path / "ref", tmp_path / "port")


@pytest.mark.parametrize("case", [HAMMING_CASES[i] for i in (0, 1, 5)],
                         ids=["single", "paired_umi", "max"])
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


@pytest.mark.parametrize("flags", [
    ["-e"], ["--coordinator", "127.0.0.1:1234"], ["--num-processes", "2"],
    ["--process-id", "0"]], ids=["edit", "coordinator", "num_processes",
                                 "process_id"])
def test_not_yet_ported_flags_exit_2(flags, tmp_path, capsys):
    from humid_tpu_torch.cli import main

    with pytest.raises(SystemExit) as exc:
        main([*flags, "-d", str(tmp_path / "o"), str(tmp_path / "x.fq")])
    assert exc.value.code == 2
    assert "not yet ported" in capsys.readouterr().err


def test_mesh_strategies_write_the_same_bytes(tmp_path):
    """run() through the ring on 3 shards and through the bucketed mesh
    search writes the bytes of the default route and of the JAX package's
    run() through its Pallas ring."""
    import humid_tpu
    import humid_tpu_torch
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
        assert res.extra["engine"] == {"strategy": strategy, "shards": 3,
                                       "ring_fallbacks": 0}
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
        {"strategy": "ring", "shards": 4, "ring_fallbacks": 0}]
    _assert_same_dirs(tmp_path / "ref", tmp_path / "port")
