"""The plain NumPy HUMID writes the statistics files of
``baseline/humid_ref`` (the C++ HUMID, built here with g++ from its one
source file, independent of both packages) and keeps the reads that its
dedup output keeps."""

import os
import shutil
import subprocess

import numpy as np
import pytest

from conftest import ROOT
from pbench import generate, harness
from reference import humid_np


@pytest.fixture(scope="module")
def humid_ref(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build baseline/humid_ref.cpp")
    out = tmp_path_factory.mktemp("humid_ref") / "humid_ref"
    subprocess.run([gxx, "-O2", "-std=c++17", "-o", str(out),
                    os.path.join(ROOT, "baseline", "humid_ref.cpp"), "-lz"],
                   check=True)
    return str(out)


CASES = [
    ("se100_default.wgs_qc", {"reads": 6000, "duplicate_share": 0.5,
                              "substitution_rate": 0.02}, 24, 1),
    ("se100_default.wgs_qc", {"reads": 6000, "duplicate_share": 0.6,
                              "substitution_rate": 0.03}, 20, 2),
    ("pe150_umi8_m2.umi_qc", {"reads": 6000, "molecules": 4000,
                              "substitution_rate": 0.02}, 24, 2),
    ("pe150_umi8_m2.umi_qc", {"reads": 6000, "molecules": 3000,
                              "substitution_rate": 0.02}, 30, 1),
    ("pe150_umi8_m2.umi_qc", {"reads": 4000, "molecules": 3000,
                              "substitution_rate": 0.02}, 6, 1),
]


@pytest.mark.parametrize("name,traffic,n,m", CASES)
def test_reference_matches_humid_ref(tmp_path, humid_ref, name, traffic, n,
                                     m):
    _, _, config, base = harness.cell(name)
    meta = generate.generate(config, {**base, **traffic}, 4242, str(tmp_path))
    ref = humid_np.humid(meta["files"], n, m)
    out = tmp_path / "out"
    subprocess.run([humid_ref, "-n", str(n), "-m", str(m), "-s", "-d",
                    str(out), *meta["files"]], check=True,
                   capture_output=True)
    for fname, data in ref.files.items():
        assert (out / fname).read_bytes() == data, fname
    # The dedup output holds the records of the representative reads.
    names = open(meta["files"][0], "rb").read().split(b"\n")[0::4]
    kept = (out / "r1_dedup.fastq").read_bytes().split(b"\n")[0::4][:-1]
    assert kept == [names[i] for i in ref.rep_reads]
    assert len(ref.degree) == len(ref.keys) == len(ref.counts)


def test_reference_filters_words_with_n_and_takes_colon_umis(tmp_path,
                                                            humid_ref):
    """Hand-made records: an N in the word filters it, a ``:``-UMI is taken
    when the ``_`` field is not a UMI, a short UMI is padded with N."""
    recs = [("r1_ACGT", "ACGTACGTAC"), ("r2_ACGT", "ACGTACGTAC"),
            ("r3_ACGA", "ACGTACGTAC"), ("r4:x_1:ACGT", "ACGTACGTAA"),
            ("r5_ACGT extra", "ACNTACGTAC"), ("r6_AC", "ACGTACGTAC")]
    path = tmp_path / "x.fastq"
    path.write_text("".join(f"@{h}\n{s}\n+\n{'F' * len(s)}\n"
                            for h, s in recs))
    ref = humid_np.humid([str(path)], 10, 1)
    out = tmp_path / "out"
    subprocess.run([humid_ref, "-n", "10", "-m", "1", "-s", "-d", str(out),
                    str(path)], check=True, capture_output=True)
    for fname, data in ref.files.items():
        assert (out / fname).read_bytes() == data, fname
    assert ref.total == 6 and ref.usable == 4


def test_neighbour_pairs_match_all_pairs():
    rng = np.random.default_rng(3)
    for length, m in ((12, 1), (12, 2), (9, 3)):
        base = rng.integers(0, 4, (300, length))
        mut = base[rng.integers(0, 300, 300)].copy()
        mut[np.arange(300), rng.integers(0, length, 300)] = rng.integers(
            0, 4, 300)
        codes = np.unique(np.concatenate([base, mut]), axis=0)
        keys = np.zeros(len(codes), np.uint64)
        for j in range(length):
            keys = (keys << np.uint64(2)) | codes[:, j].astype(np.uint64)
        a, b = humid_np.neighbour_pairs(keys, length, m)
        d = (codes[:, None, :] != codes[None, :, :]).sum(-1)
        i, j = np.nonzero(np.triu(d <= m, 1))
        assert sorted(zip(a.tolist(), b.tolist())) == sorted(
            zip(i.tolist(), j.tolist()))
