"""The plain NumPy HUMID writes the statistics files of
``baseline/humid_ref`` (the C++ HUMID, built here with g++ from its one
source file, independent of both packages) and keeps the reads that its
dedup output keeps, with Hamming neighbours and with Levenshtein ones
(``-e``)."""

import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np
import pytest

from conftest import ROOT, indel_sample
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
    # -e, on samples with copies of reads that have an indel in the word
    # ("indels": how many); at m = 1 Levenshtein and Hamming agree.
    ("se100_default.wgs_qc", {"reads": 6000, "duplicate_share": 0.5,
                              "substitution_rate": 0.02, "indels": 800,
                              "edit": True}, 24, 2),
    ("se100_default.wgs_qc", {"reads": 6000, "duplicate_share": 0.6,
                              "substitution_rate": 0.03, "indels": 800,
                              "edit": True}, 20, 3),
    ("pe150_umi8_m2.umi_qc", {"reads": 6000, "molecules": 4000,
                              "substitution_rate": 0.02, "indels": 800,
                              "edit": True}, 24, 2),
    ("se100_default.wgs_qc", {"reads": 6000, "duplicate_share": 0.5,
                              "substitution_rate": 0.02, "indels": 800,
                              "edit": True}, 24, 1),
]


@pytest.mark.parametrize("name,traffic,n,m", CASES)
def test_reference_matches_humid_ref(tmp_path, humid_ref, name, traffic, n,
                                     m):
    _, _, config, base = harness.cell(name)
    traffic = {**base, **traffic}
    edit, indels = traffic.pop("edit", False), traffic.pop("indels", 0)
    if indels:
        meta = indel_sample(config, traffic, 4242, str(tmp_path), indels, n)
    else:
        meta = generate.generate(config, traffic, 4242, str(tmp_path))
    ref = humid_np.humid(meta["files"], n, m, edit=edit)
    out = tmp_path / "out"
    subprocess.run([humid_ref, *(["-e"] if edit else []), "-n", str(n),
                    "-m", str(m), "-s", "-d", str(out), *meta["files"]],
                   check=True, capture_output=True)
    for fname, data in ref.files.items():
        assert (out / fname).read_bytes() == data, fname
    # The dedup output holds the records of the representative reads.
    names = open(meta["files"][0], "rb").read().split(b"\n")[0::4]
    kept = (out / "r1_dedup.fastq").read_bytes().split(b"\n")[0::4][:-1]
    assert kept == [names[i] for i in ref.rep_reads]
    assert len(ref.degree) == len(ref.keys) == len(ref.counts)
    if not edit:
        assert ref.candidates == 0
        return
    hamming = humid_np.humid(meta["files"], n, m)
    assert ref.candidates >= int(ref.degree.sum()) // 2 > 0
    if m == 1:
        # Words of one length within one edit differ by one substitution.
        assert ref.files == hamming.files
        for field in ("keys", "counts", "first_read", "degree", "sizes",
                      "rep_reads"):
            assert np.array_equal(getattr(ref, field),
                                  getattr(hamming, field)), field
    else:
        # The indel copies are Levenshtein neighbours, not Hamming ones.
        assert (ref.degree >= hamming.degree).all()
        assert int(ref.degree.sum()) > int(hamming.degree.sum())


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


def _levenshtein(a, b, cap: int) -> int:
    """The textbook edit distance of two sequences, one cell at a time;
    ``cap + 1`` once a whole row is above ``cap`` (a row's least cell never
    falls)."""
    prev = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        cur = [i] + [0] * len(b)
        for j in range(1, len(b) + 1):
            cur[j] = min(prev[j - 1] + (a[i - 1] != b[j - 1]), prev[j] + 1,
                         cur[j - 1] + 1)
        if min(cur) > cap:
            return cap + 1
        prev = cur
    return prev[-1]


@pytest.mark.parametrize("length,m", [(12, 2), (9, 3)])
def test_edit_pairs_match_all_pairs(length, m):
    """Random words and copies of them with one base deleted or inserted:
    the reference's Levenshtein pairs are every pair within ``m`` by a
    scalar DP, each once, and its candidates are the distinct pairs that
    some (segment, shift) search finds."""
    rng = np.random.default_rng(length * 10 + m)
    base = rng.integers(0, 4, (160, length))
    words = [list(w) for w in base]
    for w in base[rng.integers(0, 160, 160)]:
        w, pos = list(w), int(rng.integers(0, length))
        if rng.random() < 0.5:
            w = w[:pos] + w[pos + 1:] + [int(rng.integers(0, 4))]
        else:
            w = (w[:pos] + [int(rng.integers(0, 4))] + w[pos:])[:length]
        words.append(w)
    codes = np.unique(np.array(words), axis=0)
    keys = np.zeros(len(codes), np.uint64)
    for j in range(length):
        keys = (keys << np.uint64(2)) | codes[:, j].astype(np.uint64)
    a, b, candidates = humid_np.edit_pairs(keys, length, m)
    rows = codes.tolist()
    want = [(i, j) for i in range(len(rows)) for j in range(i + 1, len(rows))
            if _levenshtein(rows[i], rows[j], m) <= m]
    got = list(zip(a.tolist(), b.tolist()))
    assert sorted(got) == want and len(set(got)) == len(got)
    hamming = {tuple(p) for p in zip(*(
        x.tolist() for x in humid_np.neighbour_pairs(keys, length, m)))}
    assert hamming < set(got)
    found = set()
    for lo, size, d in humid_np.edit_probes(length, m):
        wa = humid_np.window_keys(keys, length, lo, size)
        wb = humid_np.window_keys(keys, length, lo + d, size)
        i, j = np.nonzero(wa[:, None] == wb[None, :])
        found |= {(min(p), max(p)) for p in zip(i.tolist(), j.tolist())
                  if p[0] != p[1]}
    assert candidates == len(found)


#: sha256 of ``humid(..., edit=False)``'s arrays and statistics files on
#: both cells' traffic at the CPU harness's size (seed 3000000019), as the
#: reference gave them before it learnt ``edit``.
HAMMING_DIGESTS = {
    "se100_default.wgs_qc": (
        {"reads": 3000, "duplicate_share": 0.4, "substitution_rate": 0.02},
        "bf1af951b45947cadaf40475d298f67ab35055f37c400a454a2c637eb0c44774"),
    "pe150_umi8_m2.umi_qc": (
        {"reads": 3000, "molecules": 2500, "substitution_rate": 0.02},
        "02e07734436b74bab43d01dc2e47f6073c94fbbe2ce584701b9aa9240bab91fe"),
}


@pytest.mark.parametrize("name", sorted(HAMMING_DIGESTS))
def test_hamming_reference_is_unchanged(name):
    traffic, digest = HAMMING_DIGESTS[name]
    _, _, config, base = harness.cell(name)
    with tempfile.TemporaryDirectory() as d:
        meta = generate.generate(config, {**base, **traffic}, 3000000019, d)
        res = humid_np.humid(meta["files"], config["run"]["word_length"],
                             config["run"]["distance"])
    h = hashlib.sha256()
    for arr in (res.keys, res.counts, res.first_read, res.degree, res.sizes,
                res.rep_reads):
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    for fname in sorted(res.files):
        h.update(fname.encode())
        h.update(res.files[fname])
    assert h.hexdigest() == digest
    assert res.candidates == 0
