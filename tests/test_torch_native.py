"""The port's host C extensions (``_hostops``, ``_cfastqio``,
``_ccluster``, ``_cumi``, ``_cedit``, built by ``python setup.py
build_ext``) against
the port's own numpy and Python fallbacks, on seeded random inputs.

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
            (N, ("_unique_u64", "_merge_join_native", "_first_join_native",
                 "_run_pairs_native", "_run_pairs_hamming_native")),
            (reader, ("_frame_native", "_scan_frames_native",
                      "_count_newlines_native", "_scan_frames_prefix_native",
                      "_gather_prefix_native")),
            (writer, ("_concat_native",)),
            (pipeline, ("_encode_pack", "_gather_prefix", "_gather_umi")),
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
    """merge_join_pairs and first_join_pairs in the shifted-segment edit
    search."""
    _built("_hostops")
    _built("_cedit")
    table = _table(np.random.default_rng(100 + length), 3000, length, 300,
                   m)
    native, plain = _both(monkeypatch, lambda: N.find_neighbor_pairs(
        table, m, metric="edit", strategy="runs", word_length=length,
        device="cpu"))
    _equal(native, plain)
    assert len(native[0]) > 0


def _union(keys, cols, sizes, a, b):
    """N._first_join_union over copies of the joins' pairs (it works in
    place), join p holding the next ``sizes[p]`` of them."""
    starts = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    return N._first_join_union(keys, cols, starts, a.copy(), b.copy())


@pytest.mark.parametrize("n_cols", [1, 5, 11])
def test_first_join_pairs(monkeypatch, n_cols):
    """first_join_pairs, the first-join union of the shifted edit search:
    against its numpy fallback, pairs and order, over seeded keys (few
    values, so the earlier joins find some pairs and miss others), with
    an empty join among them, with no pair at all, and with a join whose
    every pair an earlier join found."""
    _built("_cedit")
    rng = np.random.default_rng(n_cols)
    keys = [rng.integers(0, 6, 5000).astype(np.uint64)
            for _ in range(n_cols)]
    cols = [tuple(rng.integers(0, n_cols, 2).tolist()) for _ in range(12)]
    sizes = rng.integers(0, 40_000, len(cols))
    sizes[3] = 0
    a = rng.integers(0, 5000, sizes.sum())
    b = rng.integers(0, 5000, sizes.sum())
    native, plain = _both(monkeypatch,
                          lambda: _union(keys, cols, sizes, a, b))
    _equal(native, plain)
    assert 0 < len(native[0]) < len(a)
    none = np.zeros(0, np.int64)
    native, plain = _both(monkeypatch, lambda: _union(
        keys, cols, np.zeros(len(cols), np.int64), none, none))
    _equal(native, plain)
    assert len(native[0]) == 0
    # Join 1's pairs are rows equal in column 0, which join 0 (on
    # columns (0, 0)) finds: join 0's pairs are kept, join 1's go.
    x = np.flatnonzero(keys[0] == 3)
    y = x[::-1].copy()
    native, plain = _both(monkeypatch, lambda: _union(
        keys, [(0, 0), (0, 0)], [len(x), len(x)], np.concatenate([x, x]),
        np.concatenate([y, y])))
    _equal(native, plain)
    np.testing.assert_array_equal(native[0], x)


def test_edit_union_rejects_bad_input():
    """The port's join and union refuse rows outside their keys or
    table, mismatched lengths and columns out of range, and a join
    reports the size it needs when its buffer is short."""
    cedit = _built("_cedit")
    ka = np.array([5, 7, 5], np.uint64)
    kb = np.array([7, 5, 5], np.uint64)
    oa = np.argsort(ka, kind="stable")
    ob = np.argsort(kb, kind="stable")
    out = np.empty(8, np.int64), np.empty(8, np.int64)
    # (0, 1) is met both ways and comes out once; (0, 2) and (1, 2) are
    # met one way.
    n = cedit.merge_join_pairs(ka, oa, kb, ob, ka[oa], kb[ob], 0, *out)
    assert sorted(zip(out[0][:n].tolist(), out[1][:n].tolist())) == [
        (0, 1), (0, 2), (1, 2)]
    short = np.empty(1, np.int64), np.empty(1, np.int64)
    assert cedit.merge_join_pairs(ka, oa, kb, ob, ka[oa], kb[ob], 0,
                                  *short) == -3
    with pytest.raises(ValueError):
        cedit.merge_join_pairs(ka, oa + 1, kb, ob, ka[oa], kb[ob], 0, *out)
    with pytest.raises(ValueError):
        cedit.merge_join_pairs(ka, oa, kb, ob, ka[oa][:2], kb[ob], 0, *out)
    table = np.zeros((3, 2), np.uint32)
    cols = np.array([0, 1], np.int64)
    starts = np.array([0, 1, 2], np.int64)
    pairs = np.array([0, 1], np.int64), np.array([1, 2], np.int64)
    assert cedit.first_join_pairs(table, 3, 2, cols, cols, starts,
                                  *map(np.copy, pairs)) == 1
    for bad in ((table, 3, 2, cols, cols, starts,
                 np.array([0, 3], np.int64), pairs[1].copy()),
                (table, 3, 2, cols + 1, cols, starts, *map(np.copy, pairs)),
                (table, 3, 2, cols, cols, starts + 1, *map(np.copy, pairs)),
                (table.astype(np.uint8), 3, 2, cols, cols, starts,
                 *map(np.copy, pairs))):
        with pytest.raises(ValueError):
            cedit.first_join_pairs(*bad)


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
    for name in ("_hostops", "io._cfastqio", "cluster._ccluster", "io._cumi",
                 "_cedit"):
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


# ------------------------------------------------------- the UMI parse

def _random_headers(rng, n, length, alphabet):
    return [bytes(rng.choice(alphabet, int(rng.integers(0, length + 1))))
            for _ in range(n)]


def _umi_headers(style, rng):
    """Header lines (bytes, without the newline) of one kind."""
    umis = [_random_headers(rng, 1, 20, list(b"ACGT"))[0] for _ in range(40)]
    if style == "underscore":
        return [b"@r%d_" % i + u for i, u in enumerate(umis)] + [
            b"@M1:2:3_ACGTACGT", b"_ACGT", b"@a_b_c_GATTACA"]
    if style == "colon":
        return [b"@M01:%d:" % i + u for i, u in enumerate(umis)] + [
            b"@M1_2_3:ACGTACGT", b":ACGT", b"@a:b:c:GATTACA"]
    if style == "mixed":
        return [b"@a_b:ACGT", b"@a:b_ACGT", b"@a_ACGT:GG", b"@x:AC_GT",
                b"@x_AC:GT", b"@x_ACGT_:GGC", b"@x:ACGT:_GGC", b"@x_:ACG",
                b"@x:_ACG", b"@_:", b"@:_", b"@a_AC:x_GT:T"]
    if style == "spaces":
        return [b"@r_ACGT 1:N:0:ACGT", b"@r:ACGT 1:N:0:GG", b" @r_ACGT",
                b"@r_ACGT ", b"@r_ACGT  x_GGG", b"@r_AC GT", b"@r_ 1_ACGT",
                b"@r:AC GT:TT", b" ", b"  _ACGT", b"@r_ACG\tT x"]
    if style == "cr":
        return [b"@r_ACGT\r", b"@r\r_ACGT", b"@r:ACGT\r\r", b"@r_AC\rGT",
                b"\r", b"@r_ACGT\r 1:N", b"@r_\rACGT", b"@r:GG\r_ACGT"]
    if style == "invalid":
        return [b"@r_acgt", b"@r_ACNT", b"@r_", b"@r:", b"@r_ACGT_",
                b"@r:ACGT:", b"@r_N", b"@r:NNNN", b"@r_ACGu", b"@r_\x00ACG",
                b"@r_AC\x00", b"@r_ACGT\xc1", b"@r_\xff", b"@r:acgt_"]
    if style == "no_separator":
        return [b"@ACGT", b"ACGT", b"", b"@read1", b"A", b"@r-ACGT",
                b"@r.ACGT", b"@r/ACGT"]
    if style == "lengths":
        # UMIs of every length from 1 to 20 bases, in both styles.
        return [sep + (b"TGCAC" * 4)[:k] for sep in (b"@r_", b"@r:")
                for k in range(1, 21)]
    if style == "long":
        # Past 256 bytes, with the UMI, a space or both out there.
        pad = bytes(rng.choice(list(b"abcdefghijxyz0123456789"), 300))
        return [b"@" + pad + b"_ACGTACGTAC", b"@" + pad + b":GGTTAACC",
                b"@r_ACGTAC " + pad, b"@" + pad + b"_TTGG " + pad,
                b"@" + pad + b"\x00\t_CAGT", b"@" + pad * 3 + b"_ACGT",
                b"@" + pad + b"_" + b"ACGT" * 80]
    assert style == "random"
    return _random_headers(rng, 400, 300, list(b"ACGTNacgt_: \r\t\x00"))


@pytest.mark.parametrize("umi_size", [1, 8, 12])
@pytest.mark.parametrize("style", [
    "underscore", "colon", "mixed", "spaces", "cr", "invalid",
    "no_separator", "lengths", "long", "random"])
def test_gather_umi(style, umi_size):
    """gather_umi against ``extract_umi`` + ``make_string_size`` row by
    row, and against ``extract_umi_matrix`` (the fallback) on the same
    spans; the columns beside the UMI are left as they were."""
    _built("io._cumi")
    from humid_tpu_torch.io._umi import gather_umi

    rng = np.random.default_rng(umi_size * 100 + len(style))
    headers = _umi_headers(style, rng)
    # Spans into one buffer, with other bytes between them.
    parts, starts, ends, pos = [], [], [], 0
    for h in headers:
        gap = bytes(rng.choice(list(b"\nACGT_: "), int(rng.integers(1, 4))))
        parts += [gap, h]
        starts.append(pos + len(gap))
        ends.append(pos + len(gap) + len(h))
        pos += len(gap) + len(h)
    buf = np.frombuffer(b"".join(parts) + b"\n", np.uint8)
    n = len(headers)
    st = np.zeros((n, 4), np.int64)
    en = np.zeros((n, 4), np.int64)
    st[:, 0], en[:, 0] = starts, ends

    out = np.full((n, 3 + umi_size + 5), 7, np.uint8)
    gather_umi(buf, st[:, 0], en[:, 0], out, 3, umi_size)
    got = out[:, 3:3 + umi_size]
    assert (out[:, :3] == 7).all() and (out[:, 3 + umi_size:] == 7).all()

    want = [W.make_string_size(W.extract_umi(h.decode("latin1")), umi_size)
            for h in headers]
    assert [bytes(r).decode("latin1") for r in got] == want
    batch = reader.FastqBatch(buf, st, en)
    np.testing.assert_array_equal(
        got, W.extract_umi_matrix(batch.name_matrix(), umi_size,
                                  lens=en[:, 0] - st[:, 0]))


def test_gather_umi_rejects_bad_spans():
    """A span outside the buffer, or columns outside ``out``, raise."""
    _built("io._cumi")
    from humid_tpu_torch.io._umi import gather_umi

    buf = np.frombuffer(b"@r_ACGT\n", np.uint8)
    out = np.zeros((1, 8), np.uint8)
    for s, e in ((0, 9), (-1, 4), (5, 4)):
        with pytest.raises(ValueError):
            gather_umi(buf, np.array([s]), np.array([e]), out, 0, 8)
    with pytest.raises(ValueError):
        gather_umi(buf, np.array([0]), np.array([7]), out, 4, 8)
    gather_umi(buf, np.array([0]), np.array([7]), out, 0, 8)
    assert bytes(out[0]) == b"ACGTNNNN"


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("case", ["umi", "no_umi", "fallback"])
def test_umi_native_rows(monkeypatch, tmp_path, case, overlap):
    """``extra["engine"]["umi_native_rows"]``: every read of a paired UMI
    run with the extension, 0 without a UMI and 0 on the fallback, by
    pass 1 and by the overlapped route."""
    if case != "fallback":
        for name in ("_hostops", "io._cfastqio", "io._cumi"):
            _built(name)
    paths, _ = gen_dataset(np.random.default_rng(60 + overlap),
                           str(tmp_path), n_reads=700, n_files=2,
                           umi_style="none" if case == "no_umi"
                           else "underscore", ragged=True)
    with monkeypatch.context() as m:
        if overlap:
            m.setenv(pipeline.OVERLAP_ENV_VAR, "1")
        else:
            m.delenv(pipeline.OVERLAP_ENV_VAR, raising=False)
        if case == "fallback":
            _fallbacks(m)
        res = pipeline.run(paths, word_length=24, distance=1,
                           dir_name=str(tmp_path / "out"),
                           log_name=os.devnull, run_stats=True,
                           batch_records=128, device="cpu")
    engine = res.extra["engine"]
    assert res.total == 700
    assert engine["umi_native_rows"] == (res.total if case == "umi" else 0)
    routed = overlap and case != "fallback"
    assert (engine["unique"] == "overlapped") == routed


# --------------------------------------------------- the two opt-in routes

def _csr_lists(neigh):
    indptr = np.zeros(len(neigh) + 1, np.int64)
    for i, lst in enumerate(neigh):
        indptr[i + 1] = indptr[i] + len(lst)
    return indptr, np.asarray([j for lst in neigh for j in lst], np.int64)


def _oracle_walk(counts, neigh, maximum):
    """``tests/oracle.py``'s literal recursion over the same graph:
    (labels, [(size, max_leaf, max_count)] per cluster)."""
    from oracle import _Cluster, _Leaf, _assign_directional, _assign_max

    leaves = [_Leaf(count=int(c), neighbours=list(lst))
              for c, lst in zip(counts, neigh)]
    clusters = []
    for i, leaf in enumerate(leaves):
        if leaf.cluster is None:
            c = _Cluster(len(clusters) + 1)
            (_assign_max if maximum else _assign_directional)(leaves, i, c)
            clusters.append(c)
    return ([leaf.cluster.id for leaf in leaves],
            [(c.size, c.max_leaf, c.max_count) for c in clusters])


@pytest.mark.parametrize("maximum", [False, True])
def test_component_parallel_walk(maximum, monkeypatch):
    """``cluster_exact(parallel=True)`` (``cluster_parallel_into``, OpenMP
    over components) equals the sequential walk and the oracle on random
    graphs and on a table's neighbour graph; the default and
    $HUMID_TPU_TORCH_CLUSTER=seq take the sequential walk, =parallel the
    parallel one."""
    _built("cluster._ccluster")
    rng = np.random.default_rng(23 + maximum)
    for trial in range(20):
        n = int(rng.integers(2, 150))
        counts = rng.integers(1, 20, n).astype(np.int64)
        neigh = [[] for _ in range(n)]
        for i in range(n):
            for j in range(i + 1, n):
                if rng.random() < 3.0 / n:
                    neigh[i].append(j)
                    neigh[j].append(i)
        indptr, indices = _csr_lists(neigh)
        par = exact.cluster_exact(counts, indptr, indices, maximum=maximum,
                                  parallel=True)
        seq = exact.cluster_exact(counts, indptr, indices, maximum=maximum,
                                  parallel=False)
        labels, clusters = _oracle_walk(counts, neigh, maximum)
        assert par.labels.tolist() == labels, trial
        assert list(zip(par.size.tolist(), par.max_leaf.tolist(),
                        par.max_count.tolist())) == clusters, trial
        _equal([par.labels, par.max_leaf, par.max_count, par.size],
               [seq.labels, seq.max_leaf, seq.max_count, seq.size])
    table = _table(rng, 4000, 24, 300)
    a, b = N.find_neighbor_pairs(table, 1, strategy="runs", word_length=24,
                                 device="cpu")
    indptr, indices = N.pairs_to_csr(a, b, len(table))
    counts = rng.integers(1, 40, len(table)).astype(np.int64)
    walks = []
    real = exact._native.cluster

    def spy(*args, **kw):
        walks.append(kw["parallel"])
        return real(*args, **kw)

    monkeypatch.setattr(exact._native, "cluster", spy)
    results = []
    for env in (None, "seq", "parallel"):
        with monkeypatch.context() as m:
            if env is None:
                m.delenv(exact.CLUSTER_ENV_VAR, raising=False)
            else:
                m.setenv(exact.CLUSTER_ENV_VAR, env)
            r = exact.cluster_exact(counts, indptr, indices, maximum=maximum)
        results.append([r.labels, r.max_leaf, r.max_count, r.size])
    assert walks == [False, False, True]
    _equal(results[2], results[0])


def test_component_parallel_interleaved_seed_order():
    """Cluster ids of different components interleave by seed rank
    (the reference's case, ``tests/test_cluster.py:159``): components
    {0, 2} and {1, 3} seed clusters 1 and 2 in index order."""
    _built("cluster._ccluster")
    counts = np.array([5, 7, 2, 3], np.int64)
    indptr, indices = _csr_lists([[2], [3], [0], [1]])
    seq = exact.cluster_exact(counts, indptr, indices, parallel=False)
    par = exact.cluster_exact(counts, indptr, indices, parallel=True)
    _equal([par.labels, par.max_leaf], [seq.labels, seq.max_leaf])
    assert par.labels.tolist() == [1, 2, 1, 2]


@pytest.mark.parametrize("gz,annotated,n_files", [
    (False, True, 1), (True, False, 2), (False, False, 3)])
def test_overlapped_pass1_route(monkeypatch, tmp_path, gz, annotated,
                                n_files):
    """$HUMID_TPU_TORCH_OVERLAP_UNIQUE=1 (the overlapped pass 1 + unique
    route, ``merge_unique_runs``) writes the default route's bytes, with
    runs small enough that several sorted runs are merged; wide words
    (three lanes) cannot take it and run the default route."""
    for name in ("_hostops", "io._cfastqio"):
        _built(name)
    paths, _ = gen_dataset(np.random.default_rng(40 + n_files),
                           str(tmp_path), n_reads=900, n_files=n_files,
                           umi_style="underscore", gz=gz, ragged=True)
    real = pipeline._pass1_overlapped
    monkeypatch.setattr(pipeline, "_pass1_overlapped",
                        lambda *a, **kw: real(*a, **{**kw, "run_rows": 128}))

    def go(tag, word_length, overlap):
        with monkeypatch.context() as m:
            if overlap:
                m.setenv(pipeline.OVERLAP_ENV_VAR, "1")
            else:
                m.delenv(pipeline.OVERLAP_ENV_VAR, raising=False)
            out = tmp_path / tag
            res = pipeline.run(paths, word_length=word_length, distance=1,
                               dir_name=str(out), log_name=os.devnull,
                               run_stats=True, write_annotated=annotated,
                               batch_records=100, device="cpu")
        files = {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}
        return res.extra["engine"]["unique"], files

    for word_length, route in ((24, "overlapped"), (40, "host")):
        ran, got = go(f"ovl{word_length}", word_length, True)
        assert ran == route
        _, want = go(f"def{word_length}", word_length, False)
        assert got.keys() == want.keys()
        for f in got:
            a, b = got[f], want[f]
            if f.endswith(".gz"):
                import gzip

                a, b = gzip.decompress(a), gzip.decompress(b)
            assert a == b, f
