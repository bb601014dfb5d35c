"""The JAX package's randomized config fuzz (tests/test_pipeline.py::
test_fuzz_random_config_matches_oracle) run against the port: the same
seeds draw the same flag and dataset combinations, and
``humid_tpu_torch.run`` on the CPU is held against the string oracle
(tests/oracle.py) end to end: dedup and annotated outputs record for
record, the four statistics files and the scalar counts.  Each seed runs
with the default writer and with the span-cache writer forced
(HUMID_TPU_TORCH_SPAN_CACHE=1; gzip configs exercise its fallback).

Everything compared is text or integers: exact equality throughout.
"""

import os
import sys

import numpy as np
import pytest
import torch

from humid_tpu_torch.io.names import make_file_name
from humid_tpu_torch.pipeline import run

sys.path.insert(0, os.path.dirname(__file__))
from genfastq import gen_dataset, parse_fastq  # noqa: E402
from oracle import oracle_run  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny datasets, shared cores: one thread per op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read_hist(path):
    with open(path) as fh:
        return {int(a): int(b) for a, b in
                (line.split() for line in fh if line.strip())}


def _check_case(tmp_path, rng, *, n_files=1, umi_style="none", gz=False,
                distance=1, word_length=24, edit=False, maximum=False,
                ragged=False, unequal=False, n_reads=250,
                batch_records=1 << 19, pool_size=40):
    """tests/test_pipeline.py::_check_case with the port's run() on the
    CPU in place of the JAX package's."""
    src = tmp_path / "in"
    out = tmp_path / "out"
    os.makedirs(src, exist_ok=True)
    paths, files_records = gen_dataset(
        rng, str(src), n_reads=n_reads, n_files=n_files, umi_style=umi_style,
        gz=gz, ragged=ragged, unequal_lengths=unequal,
        read_len=18 if edit else 30, pool_size=pool_size)
    res = run(list(paths), word_length=word_length, distance=distance,
              log_name=str(out / "log.txt"), dir_name=str(out),
              run_stats=True, write_dedup=True, write_annotated=True,
              edit=edit, maximum=maximum, batch_records=batch_records,
              device="cpu")
    exp = oracle_run(files_records, word_length=word_length,
                     distance=distance, edit=edit, maximum=maximum)

    assert (res.total, res.usable, res.unique, res.clusters) == (
        exp.total, exp.usable, exp.unique, len(exp.clusters))
    for f, p in enumerate(paths):
        records = files_records[f]
        dedup = parse_fastq(make_file_name(p, str(out), "dedup"))
        assert dedup == [(name, seq, "+", "F" * len(seq)) for name, seq in
                         (records[t] for t in exp.rep_tuples)], (
            f"dedup mismatch file {f}")
        annotated = parse_fastq(make_file_name(p, str(out), "annotated"))
        assert annotated == [
            (f"{records[t][0]}:{exp.cluster_of_read[t]}", records[t][1],
             "+", "F" * len(records[t][1])) for t in range(exp.total)], (
            f"annotated mismatch file {f}")
    assert _read_hist(out / "counts.dat") == exp.counts_hist
    assert _read_hist(out / "neigh.dat") == exp.neigh_hist
    assert _read_hist(out / "clusters.dat") == exp.cluster_hist
    with open(out / "stats.dat") as fh:
        stats = {k: int(v) for k, v in (ln.strip().split(": ") for ln in fh)}
    assert (stats["total"], stats["usable"], stats["unique"],
            stats["clusters"]) == (exp.total, exp.usable, exp.unique,
                                   len(exp.clusters))


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
    _check_case(tmp_path, rng, **cfg)
