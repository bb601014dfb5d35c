"""The JAX package's randomized config fuzz (tests/test_pipeline.py::
test_fuzz_random_config_matches_oracle) run against the port: the same
seeds draw the same flag and dataset combinations, and
``humid_tpu_torch.run`` on the CPU is held against the string oracle
(tests/oracle.py) end to end by ``humid_tpu_torch.tools.fuzz_oracle.
check_case``: dedup and annotated outputs record for record, the four
statistics files and the scalar counts.  Each seed runs
with the default writer and with the span-cache writer forced
(HUMID_TPU_TORCH_SPAN_CACHE=1; gzip configs exercise its fallback).

Everything compared is text or integers: exact equality throughout.
"""


import numpy as np
import pytest
import torch

from humid_tpu_torch.tools.fuzz_oracle import check_case


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny datasets, shared cores: one thread per op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize(
    "seed", [101, 202, 303, 404, 505, 606, 707, 808, 909, 1010])
@pytest.mark.parametrize("span_cache", [False, True],
                         ids=["default", "spans"])
def test_fuzz_random_config_matches_oracle(tmp_path, seed, span_cache,
                                           monkeypatch):
    """The reference's draw, seed for seed: random flag and dataset
    combinations the hand-written cases do not enumerate."""
    monkeypatch.delenv("HUMID_TPU_TORCH_SPAN_CACHE", raising=False)
    if span_cache:
        monkeypatch.setenv("HUMID_TPU_TORCH_SPAN_CACHE", "1")
    rng = np.random.default_rng(seed)
    n_files = int(rng.integers(1, 4))
    cfg = dict(
        n_files=n_files,
        umi_style=["none", "underscore", "colon"][int(rng.integers(0, 3))],
        gz=bool(rng.integers(0, 2)),
        distance=int(rng.integers(0, 3)),
        word_length=int(rng.integers(12, 33)),
        edit=bool(rng.integers(0, 4) == 0),
        maximum=bool(rng.integers(0, 2)),
        ragged=bool(rng.integers(0, 2)),
        unequal=bool(rng.integers(0, 2)) and n_files > 1,
        n_reads=int(rng.integers(100, 400)),
        batch_records=int(rng.choice([64, 1 << 10, 1 << 19])),
    )
    check_case(tmp_path, rng, device="cpu", **cfg)
