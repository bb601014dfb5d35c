"""The benchmark's CPU tests: ``python -m pytest benchmark/tests``.

They put the benchmark's folder and the checkout's root on the path, as
``benchmark/run.py`` does, and keep every test's environment and data
cache to itself."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]


@pytest.fixture
def bench_env(tmp_path, monkeypatch):
    """The harness writes its caches under ``tmp_path``; the variables it
    sets are restored afterwards."""
    from pbench import harness

    saved = dict(os.environ)
    monkeypatch.setattr(harness, "CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("HUMID_TPU_TORCH_DEVICE", "cpu")
    yield tmp_path
    os.environ.clear()
    os.environ.update(saved)
