"""The benchmark's CPU tests: ``python -m pytest benchmark/tests``.

They put the benchmark's folder and the checkout's root on the path, as
``benchmark/run.py`` does, and keep every test's environment and data
cache to itself."""

import os
import sys

import numpy as np
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


def indel_sample(config: dict, traffic: dict, seed: int, out_dir: str,
                 indels: int, word_length: int) -> dict:
    """The traffic's sample (``pbench/generate.py``'s reads) with
    ``indels`` more reads: copies of reads drawn from the seed, each with
    one base deleted or inserted inside the word's part of the first
    file's read (a deletion pulls the next base in at the read's end, an
    insertion pushes the last one out).  Written with
    ``generate.write_fastq``; returns what ``generate.generate`` does."""
    from pbench import generate

    layout = config["layout"]
    umi_len, read_len = int(layout["umi_length"]), int(layout["read_length"])
    files = int(layout["files"])
    codes = generate.sample_codes(config, traffic, seed,
                                  generate.generator(traffic).molecules)
    rng = np.random.default_rng(seed + 1)
    in_word = max(1, (word_length - umi_len) // files)
    copies = codes[rng.integers(0, len(codes), indels)].copy()
    for row, pos, ins, base in zip(copies, rng.integers(0, in_word, indels),
                                   rng.random(indels) < 0.5,
                                   rng.integers(0, 4, indels)):
        read = row[umi_len:umi_len + read_len]
        if ins:
            read[pos + 1:] = read[pos:-1].copy()
            read[pos] = base
        else:
            read[pos:-1] = read[pos + 1:].copy()
            read[-1] = base
    codes = np.concatenate([codes, copies])
    umi = codes[:, :umi_len] if umi_len else None
    paths = []
    for k in range(files):
        path = os.path.join(out_dir, f"r{k + 1}.fastq")
        lo = umi_len + k * read_len
        generate.write_fastq(path, codes[:, lo:lo + read_len], umi)
        paths.append(path)
    return {"files": paths, "reads": int(len(codes))}
