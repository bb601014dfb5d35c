"""The port's three host C extensions (``_hostops``, ``_cfastqio``,
``_ccluster``, built by ``python setup.py build_ext``) against the
port's own numpy and Python fallbacks, on seeded random inputs.

Every function of the extensions that the port calls is reached through
the port's code twice: once as it stands, once with every extension hook
set to None (:func:`_fallbacks`), which is what a checkout without the
built extensions runs.  The results are integer arrays or bytes, so
every comparison is exact.  A test whose extension is not built skips.

Imports no jax and nothing of the JAX package: ``python -m
humid_tpu_torch.tools.check_native --host`` runs this file under
AddressSanitizer on hosts without jax.
"""

import os
import sys

import numpy as np
import pytest

import humid_tpu_torch.io as io
from humid_tpu_torch import pipeline
from humid_tpu_torch import words as W
from humid_tpu_torch.cluster import exact
from humid_tpu_torch.io import reader, writer
from humid_tpu_torch.ops import neighbors as N
from humid_tpu_torch.ops import unique as U
from humid_tpu_torch.parallel import cluster as PC

sys.path.insert(0, os.path.dirname(__file__))
from genfastq import gen_dataset  # noqa: E402


def _built(name: str):
    return pytest.importorskip(f"humid_tpu_torch.{name}",
                               reason=f"{name} not built")


def _fallbacks(monkeypatch) -> None:
    """Every extension hook of the port set to None: the code paths of a
    checkout without the built extensions."""
    for mod, names in (
            (U, ("_argsort_u64", "_unique_u64", "_unique_packed")),
            (N, ("_unique_u64", "_merge_join_native", "_run_pairs_native",
                 "_run_pairs_hamming_native")),
            (reader, ("_frame_native", "_scan_frames_native",
                      "_count_newlines_native", "_scan_frames_prefix_native",
                      "_gather_prefix_native")),
            (writer, ("_concat_native",)),
            (pipeline, ("_encode_pack", "_gather_prefix")),
            (exact, ("_native",))):
        for name in names:
            monkeypatch.setattr(mod, name, None)
    # Imported inside functions: a None entry makes the import raise.
    monkeypatch.setitem(sys.modules, "humid_tpu_torch.cluster._native", None)


def _both(monkeypatch, fn):
    """fn() with the extensions, then with the fallbacks."""
    native = fn()
    with monkeypatch.context() as m:
        _fallbacks(m)
        return native, fn()


def _equal(got, want) -> None:
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif got is None or isinstance(got, (int, bytes, str)):
        assert got == want
    else:
        np.testing.assert_array_equal(got, want)


def _table(rng, n, length, pool, subst=1):
    """[n] words of ``length`` bases from a pool of ``pool`` sequences,
    each with up to ``subst`` substitutions: packed, unique, sorted."""
    base = rng.integers(0, 4, (pool, length), dtype=np.uint8)
    codes = base[rng.integers(0, pool, n)]
    for _ in range(subst):
        hit = np.flatnonzero(rng.random(n) < 0.4)
        codes[hit, rng.integers(0, length, len(hit))] = rng.integers(
            0, 4, len(hit), dtype=np.uint8)
    uniq, _, _, _ = U.unique_words(W.pack_words(codes), want_inverse=False,
                                   device="cpu")
    return uniq


@pytest.mark.parametrize("want_inverse", [False, True])
@pytest.mark.parametrize("length", [12, 24, 40, 80])
def test_unique_words(monkeypatch, length, want_inverse):
    """unique_packed (w <= 2), unique_u64 and argsort_u64 (wider words)."""
    _built("_hostops")
    rng = np.random.default_rng(length)
    pool = rng.integers(0, 4, (150, length), dtype=np.uint8)
    packed = W.pack_words(pool[rng.integers(0, 150, 3000)])
    packed[:7] = np.uint32(0xFFFFFFFF)
    native, plain = _both(monkeypatch, lambda: U.unique_words(
        packed, want_inverse, device="cpu"))
    _equal(native, plain)


def test_argsort_u64_is_stable(monkeypatch):
    _built("_hostops")
    rng = np.random.default_rng(7)
    key = rng.integers(0, 50, 20_000).astype(np.uint64) << np.uint64(40)
    native, plain = _both(monkeypatch, lambda: U._stable_argsort_u64(key))
    _equal(native, plain)


@pytest.mark.parametrize("length,m", [(24, 1), (24, 2), (33, 3), (48, 2)])
def test_runs_engine(monkeypatch, length, m):
    """run_pairs_hamming (w <= 2), run_pairs (wider), unique_u64 in the
    host pigeonhole engine."""
    _built("_hostops")
    table = _table(np.random.default_rng(length + m), 6000, length, 400, m)
    native, plain = _both(monkeypatch, lambda: N.find_neighbor_pairs(
        table, m, strategy="runs", word_length=length, device="cpu"))
    _equal(native, plain)
    assert len(native[0]) > 0


@pytest.mark.parametrize("length,m", [(18, 1), (24, 2)])
def test_edit_shifted_search(monkeypatch, length, m):
    """merge_join_pairs in the shifted-segment edit search."""
    _built("_hostops")
    table = _table(np.random.default_rng(100 + length), 3000, length, 300,
                   m)
    native, plain = _both(monkeypatch, lambda: N.find_neighbor_pairs(
        table, m, metric="edit", strategy="runs", word_length=length,
        device="cpu"))
    _equal(native, plain)
    assert len(native[0]) > 0


@pytest.mark.parametrize("n_files,gz,umi,batch", [
    (1, False, "none", 64), (2, True, "underscore", 1 << 10),
    (3, False, "colon", 37)])
def test_read_tuples_and_records(monkeypatch, tmp_path, n_files, gz, umi,
                                 batch):
    """count_newlines, frame, scan_frames(_prefix), gather_prefix,
    gzip_decompress, concat_segments: framing and the output writers."""
    _built("io._cfastqio")
    gen_dataset(np.random.default_rng(n_files), str(tmp_path), n_reads=400,
                n_files=n_files, umi_style=umi, gz=gz, ragged=True,
                unequal_lengths=True)
    ext = "fastq.gz" if gz else "fastq"
    files = [str(tmp_path / f"file{i}.{ext}") for i in range(n_files)]

    def read():
        out = []
        for batches in io.read_tuples(files, batch, prefix_ks=[9] * n_files):
            for b in batches:
                ids = np.arange(b.n) % 5
                out.append((bytes(io.build_records(b, np.arange(0, b.n, 3))),
                            bytes(io.build_records_annotated(b, ids))))
        return out

    native, plain = _both(monkeypatch, read)
    _equal(native, plain)


@pytest.mark.parametrize("maximum", [False, True])
def test_cluster_exact(monkeypatch, maximum):
    """cluster_into: the directional walk and -x."""
    _built("cluster._ccluster")
    rng = np.random.default_rng(11 + maximum)
    table = _table(rng, 4000, 24, 300)
    a, b = N.find_neighbor_pairs(table, 1, strategy="runs", word_length=24,
                                 device="cpu")
    indptr, indices = N.pairs_to_csr(a, b, len(table))
    counts = rng.integers(1, 40, len(table)).astype(np.int64)

    def walk():
        r = exact.cluster_exact(counts, indptr, indices, maximum=maximum)
        return r.labels, r.max_leaf, r.max_count, r.size

    native, plain = _both(monkeypatch, walk)
    _equal(native, plain)


@pytest.mark.parametrize("maximum", [False, True])
def test_components_and_masked_walk(monkeypatch, maximum):
    """components_into and cluster_masked_into: a host shard's local step
    of the multi-process cluster phase, against label propagation and the
    walk over the owned components' subgraph."""
    _built("cluster._ccluster")
    rng = np.random.default_rng(21 + maximum)
    table = _table(rng, 4000, 24, 600)
    a, b = N.find_neighbor_pairs(table, 1, strategy="runs", word_length=24,
                                 device="cpu")
    indptr, indices = N.pairs_to_csr(a, b, len(table))
    counts = rng.integers(1, 40, len(table)).astype(np.int64)
    for shard in ((0, 3), (2, 3)):
        native, plain = _both(monkeypatch, lambda: PC.cluster_sharded_local(
            counts, indptr, indices, a, b, maximum=maximum, shard=shard,
            device="cpu"))
        _equal(native, plain)
        assert len(native[0]) > 0


@pytest.mark.parametrize("gz,maximum,edit", [
    (False, False, False), (True, True, False), (False, False, True)])
def test_run_end_to_end(monkeypatch, tmp_path, gz, maximum, edit):
    """encode_pack and every hook above through ``run()``: the same
    output bytes with the extensions and without."""
    for name in ("_hostops", "io._cfastqio", "cluster._ccluster"):
        _built(name)
    paths, _ = gen_dataset(np.random.default_rng(5 + gz), str(tmp_path),
                           n_reads=500, n_files=2, umi_style="underscore",
                           gz=gz, ragged=True, read_len=18 if edit else 30)

    def go(tag):
        out = tmp_path / tag
        pipeline.run(paths, word_length=16, distance=1, dir_name=str(out),
                     log_name=os.devnull, run_stats=True, write_dedup=True,
                     write_annotated=True, maximum=maximum, edit=edit,
                     batch_records=128, device="cpu")
        return {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}

    native = go("native")
    with monkeypatch.context() as m:
        _fallbacks(m)
        plain = go("plain")
    assert native.keys() == plain.keys() and len(native) == 8
    for f in native:
        got, want = native[f], plain[f]
        if f.endswith(".gz"):
            import gzip

            got, want = gzip.decompress(got), gzip.decompress(want)
        assert got == want, f
