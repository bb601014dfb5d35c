"""The port's whole-run profiler hook (``run(profile_dir=)`` /
$HUMID_TPU_TORCH_PROFILE) on the CPU: one parseable Chrome trace holding
the phase ranges, and the same output bytes as an unprofiled run.

Inputs are made with numpy from fixed seeds; outputs are compared byte
for byte.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from humid_tpu_torch import pipeline as P
from humid_tpu_torch import run

sys.path.insert(0, os.path.dirname(__file__))
from genfastq import gen_dataset  # noqa: E402
from test_torch_pipeline import _assert_same_dirs  # noqa: E402

PHASES = ("Determing nucleotides to take", "Reading data",
          "Calculating neighbours using Hamming distance",
          "Calculating directional clusters", "Writing filtered results")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny inputs, shared cores: one thread per op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu_and_clean_env(monkeypatch):
    monkeypatch.setenv("HUMID_TPU_TORCH_DEVICE", "cpu")
    for var in (P.PROFILE_ENV_VAR, "HUMID_TPU_TORCH_FUSED",
                "HUMID_TPU_TORCH_SPAN_CACHE"):
        monkeypatch.delenv(var, raising=False)


def _trace(profile_dir):
    names = os.listdir(profile_dir)
    assert len(names) == 1 and names[0].endswith(".json"), names
    with open(os.path.join(profile_dir, names[0])) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name") for e in events}


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_profiler_writes_one_trace_and_same_bytes(how, tmp_path,
                                                  monkeypatch):
    gen_dataset(np.random.default_rng(63), str(tmp_path), n_reads=300,
                n_files=2, umi_style="underscore")
    files = [str(tmp_path / f"file{i}.fastq") for i in range(2)]
    kw = dict(log_name=os.devnull, run_stats=True, write_annotated=True)
    run(files, dir_name=str(tmp_path / "plain"), **kw)
    prof = str(tmp_path / "profile")
    if how == "argument":
        run(files, dir_name=str(tmp_path / "profiled"), profile_dir=prof,
            **kw)
    else:
        monkeypatch.setenv(P.PROFILE_ENV_VAR, prof)
        run(files, dir_name=str(tmp_path / "profiled"), **kw)
    names = _trace(prof)
    for phase in PHASES:
        assert phase in names, phase
    _assert_same_dirs(tmp_path / "plain", tmp_path / "profiled")


def test_empty_profile_dir_profiles_nothing(tmp_path, monkeypatch):
    """profile_dir="" (how the hook re-enters run) overrides the
    environment variable."""
    gen_dataset(np.random.default_rng(64), str(tmp_path), n_reads=100)
    monkeypatch.setenv(P.PROFILE_ENV_VAR, str(tmp_path / "profile"))
    run([str(tmp_path / "file0.fastq")], dir_name=str(tmp_path / "o"),
        log_name=os.devnull, profile_dir="")
    assert not os.path.exists(tmp_path / "profile")
