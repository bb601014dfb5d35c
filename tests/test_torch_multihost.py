"""The port's multi-process helpers (humid_tpu_torch.parallel.multihost,
the ownership hash of ops.neighbors, the component wrappers of
cluster._native) against the JAX package's on the same arrays.

Inputs come from fixed numpy seeds (tests/genfastq.py for reads).  Every
value compared is integer or byte data: exact equality, tolerance 0.
"""

import os
import sys
import types

import numpy as np
import pytest

from humid_tpu.ops import neighbors as JN
from humid_tpu.parallel import multihost as JMH
from humid_tpu.parallel import pipeline as JPP
from humid_tpu_torch import words as W
from humid_tpu_torch.ops import neighbors as N
from humid_tpu_torch.ops import unique_words
from humid_tpu_torch.parallel import multihost as MH
from humid_tpu_torch.parallel import pipeline as PP

sys.path.insert(0, os.path.dirname(__file__))
from genfastq import gen_dataset  # noqa: E402


def _host_tables(rng, n_hosts, n, length, pool=50):
    """Per-host (uniq, counts, global first occurrences) of slices of one
    read population, as each host of a run computes them."""
    base = rng.integers(0, 4, (pool, length), dtype=np.uint8)
    codes = base[rng.integers(0, pool, n)]
    packed = W.pack_words(codes)
    out = []
    for p in range(n_hosts):
        lo, hi = MH.host_record_range(n, p, n_hosts)
        u, c, f, _ = unique_words(packed[lo:hi], want_inverse=False,
                                  device="cpu")
        out.append((u, c, f + lo))
    return packed, out


@pytest.mark.parametrize("total,n", [(10, 3), (100, 4), (7, 1), (5, 8)])
def test_host_record_range(total, n):
    got = [MH.host_record_range(total, p, n) for p in range(n)]
    assert got == [JMH.host_record_range(total, p, n) for p in range(n)]
    assert got[0][0] == 0 and got[-1][1] == total


@pytest.mark.parametrize("length", [12, 24, 33, 70])
@pytest.mark.parametrize("n_hosts", [2, 3])
def test_combine_and_merge_unique_tables(length, n_hosts):
    """Widths 1, 2, 3 and 5 lanes: the merged table equals the JAX merge
    and a single host's unique counting over all reads."""
    rng = np.random.default_rng(length * 10 + n_hosts)
    packed, per = _host_tables(rng, n_hosts, 3000, length)
    slots = [[t[i] for t in per] for i in range(3)]
    got = MH.combine_unique_tables(*slots)
    want = JMH.combine_unique_tables(*slots)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    gather = lambda arrs: [[t[i] for t in per] for i in range(len(arrs))]
    merged = MH.merge_unique_tables(*per[0], all_gather=gather)
    for g, w_ in zip(merged, got):
        np.testing.assert_array_equal(g, w_)
    u, c, f, _ = unique_words(packed, want_inverse=False, device="cpu")
    np.testing.assert_array_equal(got[0], u)
    np.testing.assert_array_equal(got[1], c)
    np.testing.assert_array_equal(got[2], f)


@pytest.mark.parametrize("length", [12, 24, 40])
def test_global_unique_index(length):
    rng = np.random.default_rng(length)
    packed, per = _host_tables(rng, 3, 2000, length)
    uniq_g = MH.combine_unique_tables(*[[t[i] for t in per]
                                        for i in range(3)])[0]
    local = packed[700:1400]
    got = MH.global_unique_index(uniq_g, local)
    np.testing.assert_array_equal(got, JMH.global_unique_index(uniq_g, local))
    np.testing.assert_array_equal(uniq_g[got], local)


def test_engine_codes_follow_each_registry():
    """Both packages derive the broadcast's wire codes the same way, from
    their own registries (sorted names -> dense ints).  The port's
    shardable engines are the reference's and its dense sweep (whose
    stripes honour a shard); its mesh row, like the reference's, is not
    shardable."""
    from humid_tpu import _backend as JB
    from humid_tpu_torch import _backend as B

    for mod, reg in ((MH, B._NEIGHBOR_ENGINES), (JMH, JB._NEIGHBOR_ENGINES)):
        by_name, by_code = mod._engine_codes()
        assert by_name == {n: i for i, n in enumerate(sorted(reg))}
        assert {by_code[i]: i for i in by_code} == by_name
    assert B._SHARDABLE_ENGINES <= set(B._NEIGHBOR_ENGINES)
    assert B._SHARDABLE_ENGINES == JB._SHARDABLE_ENGINES | {"dense"}
    assert "sharded_bucketed" in set(B._NEIGHBOR_ENGINES) - (
        B._SHARDABLE_ENGINES)


def test_broadcast_engine_choice_adopts_process_0(monkeypatch):
    from humid_tpu_torch import _backend as B

    picks = iter(["runs_device"])
    monkeypatch.setattr(B, "pick_neighbor_engine",
                        lambda dev, u, shardable_only=False: next(picks))
    codes = MH._engine_codes()[0]
    sent = []

    def gather(arrs):
        sent.append(int(arrs[0][0]))
        return [[np.asarray([codes["runs_device"]]), np.asarray([-1])]]

    assert MH.broadcast_engine_choice(u=5000, device="cpu", all_gather=gather,
                                      process_id=0) == "runs_device"
    # Other processes never ask their router and send -1.
    assert MH.broadcast_engine_choice(u=5000, device="cpu", all_gather=gather,
                                      process_id=1) == "runs_device"
    assert sent == [codes["runs_device"], -1]


@pytest.mark.parametrize("engine", ["dense", "runs", "bucketed",
                                    "runs_device"])
def test_every_shardable_engine_crosses_the_broadcast(engine, monkeypatch):
    """Process 0's router is asked at the merged table's size among the
    shardable engines, and its pick, ``dense`` included, reaches every
    process through the wire codes."""
    from humid_tpu_torch import _backend as B

    asked = []
    monkeypatch.setattr(B, "pick_neighbor_engine",
                        lambda dev, u, shardable_only=False: (
                            asked.append((u, shardable_only)) or engine))
    sent = []

    def gather(arrs):
        sent.append(np.asarray(arrs[0]).copy())
        return [[sent[0], np.asarray([-1]), np.asarray([-1])]]

    got = [MH.broadcast_engine_choice(u=178_793, device="cpu",
                                      all_gather=gather, process_id=p)
           for p in range(3)]
    assert got == [engine] * 3
    assert asked == [(178_793, True)]


@pytest.mark.parametrize("n_hosts", [1, 2, 3])
def test_merge_edge_lists(n_hosts):
    rng = np.random.default_rng(n_hosts)
    parts = []
    for _ in range(n_hosts):
        a = rng.integers(0, 200, 300)
        b = a + rng.integers(1, 50, 300)
        parts.append((a, b))
    gather = lambda arrs: [[p[i] for p in parts] for i in range(2)]
    got = MH.merge_edge_lists(*parts[0], all_gather=gather)
    want = JMH.merge_edge_lists(*parts[0], all_gather=gather)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    assert got[0].dtype == np.int64


def _keys(rng, n):
    """uint64 keys, many with the top bit set, plus the edge values."""
    k = rng.integers(0, 1 << 63, n, dtype=np.uint64) | (
        rng.integers(0, 2, n, dtype=np.uint64) << np.uint64(63))
    edge = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1,
                     0x9E3779B97F4A7C15], np.uint64)
    return np.concatenate([k, edge])


@pytest.mark.parametrize("n_parts", [1, 2, 3, 4, 7, 1000003])
@pytest.mark.parametrize("salt_idx", [0, 1, 5, 101])
def test_owned_mask_matches_jax(n_parts, salt_idx):
    """The ownership hash equals the JAX one bit for bit, top-bit keys
    included, and gives every key exactly one owner."""
    keys = _keys(np.random.default_rng(n_parts + salt_idx), 5000)
    np.testing.assert_array_equal(N._mix64(keys), JN._mix64(keys))
    for part in sorted({0, n_parts // 2, n_parts - 1}):
        shard = (part, n_parts)
        want = JN._owned_mask(keys, shard, salt_idx)
        np.testing.assert_array_equal(N._owned_mask(keys, shard, salt_idx),
                                      want)
    # Every key has exactly one owner.
    owners = sum(N._owned_mask(keys, (p, min(n_parts, 5)), salt_idx)
                 .astype(int) for p in range(min(n_parts, 5)))
    assert (owners == 1).all()


@pytest.mark.parametrize("shard", [(2, 2), (-1, 2), (0, 0)])
def test_bad_shard_raises(shard):
    uniq = W.pack_words(np.random.default_rng(0).integers(
        0, 4, (50, 24), dtype=np.uint8))
    with pytest.raises(ValueError):
        N.find_neighbor_pairs(uniq, 1, word_length=24, device="cpu",
                              shard=shard)


def test_scaling_report_equals_reference():
    rng = np.random.default_rng(4)
    per_host = rng.random((3, len(PP._SCALING_PHASES)))
    per_host[:, 7] = 0.0  # a phase no process ran is left out
    assert PP._SCALING_PHASES == JPP._SCALING_PHASES
    assert PP.scaling_report(per_host, 3) == JPP.scaling_report(per_host, 3)


def _fastq(tmp_path, gz=False, **kw):
    gen_dataset(np.random.default_rng(31), str(tmp_path), n_reads=600,
                n_files=1, umi_style="none", gz=gz, **kw)
    return str(tmp_path / ("file0.fastq.gz" if gz else "file0.fastq"))


def test_range_helpers_equal_reference(tmp_path):
    """Record counting and record offsets (skip_to_record and the chunk
    table), on a plain file and its gzip copy."""
    import gzip

    from humid_tpu.io.reader import skip_to_record as j_skip
    from humid_tpu_torch.io import skip_to_record

    plain = _fastq(tmp_path)
    gz = str(tmp_path / "copy.fastq.gz")
    with open(plain, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    for f in (plain, gz):
        assert PP.count_records(f) == JPP.count_records(f) == 600
        assert PP._count_records_one(f) == 600
    n, table = PP._scan_plain_counts(plain)
    assert n == 600 and PP._scan_plain_counts(gz) is None
    for k in (0, 1, 150, 599, 600, 601):
        assert skip_to_record(plain, k) == j_skip(plain, k)
        assert PP._offset_from_table(plain, k, table) == \
            JPP._offset_from_table(plain, k, table)
    assert skip_to_record(gz, 5) is None
    n, tables = PP.count_records_with_tables([plain, gz])
    assert n == 600 and tables[1] is None
    np.testing.assert_array_equal(tables[0], table)


@pytest.mark.parametrize("tail", [b"", b"\n", b"   \n", b"ACGT"])
def test_count_records_final_line_rule(tmp_path, tail):
    path = str(tmp_path / "t.fastq")
    with open(path, "wb") as f:
        f.write(b"@r1\nACGT\n+\nIIII\n@r2\nACGT\n+\nIIII" + tail)
    assert PP.count_records(path) == JPP.count_records(path)


@pytest.mark.parametrize("lo,hi", [(0, 300), (300, 600), (100, 400),
                                   (0, 600), (200, 200)])
def test_gz_spill_range(tmp_path, lo, hi):
    """The spill holds the range's bytes at their stream offsets and ends
    at the range's end, as the reference's does."""
    import gzip

    gz = _fastq(tmp_path, gz=True)
    raw = gzip.open(gz).read()
    got = PP._spill_gz_range(gz, lo, hi, str(tmp_path / "a"))
    want = JPP._spill_gz_range(gz, lo, hi, str(tmp_path / "b"))
    assert got == want
    so, eo = got
    data = open(str(tmp_path / "a"), "rb").read()
    assert len(data) == eo and data[so:eo] == raw[so:eo]


def test_pack_host_range_equals_reference(tmp_path):
    gen_dataset(np.random.default_rng(8), str(tmp_path), n_reads=500,
                n_files=2, umi_style="underscore")
    files = [str(tmp_path / f"file{i}.fastq") for i in range(2)]
    for lo, hi in ((0, 500), (120, 333)):
        offs = [PP._offset_from_table(f, lo, t)
                for f, t in zip(files, PP.count_records_with_tables(files)[1])]
        got = PP.pack_host_range(files, lo, hi, start_offsets=offs)
        want = JPP.pack_host_range(files, lo, hi, start_offsets=offs)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g, w_)


@pytest.fixture
def fake_ccluster(monkeypatch):
    """A stand-in for the native ``_ccluster`` module (its builds are not
    part of this run) that records the calls reaching it."""
    import importlib

    calls = []
    fake = types.ModuleType("humid_tpu_torch.cluster._ccluster")
    fake.components_into = lambda a, b, labels: calls.append("components")
    fake.cluster_masked_into = lambda *a: calls.append("masked") or 0
    monkeypatch.setitem(sys.modules, "humid_tpu_torch.cluster._ccluster",
                        fake)
    monkeypatch.delitem(sys.modules, "humid_tpu_torch.cluster._native",
                        raising=False)
    native = importlib.import_module("humid_tpu_torch.cluster._native")
    yield native, calls
    import humid_tpu_torch.cluster as C

    sys.modules.pop("humid_tpu_torch.cluster._native", None)
    if getattr(C, "_native", None) is native:
        delattr(C, "_native")


@pytest.mark.parametrize("a,b", [([0, 5], [1, 10]), ([-1], [2]),
                                 ([0, 3], [1, 2**40]), ([0], [1, 2])])
def test_components_wrapper_checks_endpoints(fake_ccluster, a, b):
    """A bad endpoint (or unequal lists) raises before the native pass,
    which would index its parent array with it unchecked."""
    native, calls = fake_ccluster
    with pytest.raises(ValueError):
        native.components(np.asarray(a), np.asarray(b), 10)
    assert calls == []
    native.components(np.asarray([0, 3]), np.asarray([1, 9]), 10)
    assert calls == ["components"]


def test_native_wrappers_where_built():
    """components and cluster_masked against the port's device components
    and its Python walk, where the extension is built."""
    native = pytest.importorskip("humid_tpu_torch.cluster._native",
                                 exc_type=ImportError)
    from humid_tpu_torch.cluster import (cluster_exact,
                                         connected_components_device)
    from humid_tpu_torch.ops import pairs_to_csr

    rng = np.random.default_rng(2)
    u = 400
    a = rng.integers(0, u, 300)
    b = np.minimum(u - 1, a + rng.integers(1, 20, 300))
    np.testing.assert_array_equal(native.components(a, b, u),
                                  connected_components_device(a, b, u, "cpu"))
    counts = rng.integers(1, 50, u)
    indptr, indices = pairs_to_csr(a, b, u)
    labels, seeds, ml, mc, sz = native.cluster_masked(
        counts, indptr, indices, False, np.ones(u, np.uint8))
    want = cluster_exact(counts, indptr, indices, use_native=False)
    np.testing.assert_array_equal(labels, want.labels)
    np.testing.assert_array_equal(ml, want.max_leaf)


@pytest.mark.parametrize("n_hosts", [2, 3, 5])
def test_cluster_sharded_local_matches_jax(n_hosts):
    """The extension-less local step (components on the device, ownership
    hashed on the host) gives each host the JAX package's arrays, and
    the merge gives the full-table walk's result."""
    from humid_tpu.parallel.cluster import cluster_sharded_local as jlocal
    from humid_tpu_torch.cluster import cluster_exact
    from humid_tpu_torch.ops import pairs_to_csr
    from humid_tpu_torch.parallel.cluster import (cluster_sharded_local,
                                                  cluster_sharded_merge)

    rng = np.random.default_rng(n_hosts)
    u = 600
    a = rng.integers(0, u, 500)
    b = np.minimum(u - 1, a + rng.integers(1, 30, 500))
    pa, pb = N._dedupe_pairs(np.minimum(a, b), np.maximum(a, b))
    keep = pa != pb
    pa, pb = pa[keep], pb[keep]
    counts = rng.integers(1, 50, u).astype(np.int64)
    indptr, indices = pairs_to_csr(pa, pb, u)
    for maximum in (False, True):
        outs = [cluster_sharded_local(counts, indptr, indices, pa, pb,
                                      maximum=maximum, shard=(q, n_hosts),
                                      device="cpu")
                for q in range(n_hosts)]
        for q, got in enumerate(outs):
            want = jlocal(counts, indptr, indices, pa, pb, maximum=maximum,
                          shard=(q, n_hosts))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        merged = cluster_sharded_merge(
            u, [[o[s] for o in outs] for s in range(5)])
        ref = cluster_exact(counts, indptr, indices, maximum=maximum)
        np.testing.assert_array_equal(merged.labels, ref.labels)
        np.testing.assert_array_equal(merged.max_leaf, ref.max_leaf)
        np.testing.assert_array_equal(merged.size, ref.size)
