"""The reference's remaining routes and names in the port, each held
against the JAX package on the same seeded numpy input.

* The neighbour engines' ``impl=`` choice: the block functions
  (``hamming_block_xor`` / ``hamming_block_mxu``, ``onehot_bases``), the
  one-hot matrix-product route (the reference's ``impl="mxu"``) against
  the plain version and the JAX package's dense ``mxu`` scan, every
  engine under every ``impl``, the ``pallas_ring`` names,
  ``cap_total``, $HUMID_TPU_TORCH_IMPL.
* The two opt-in host routes' Python gates: which walk
  ``cluster_exact`` takes for each ``parallel=`` and environment, which
  unique route ``run()`` takes for each opt-in, word width and extension,
  and that an opt-in that cannot engage keeps the fused route.
* The public helpers the reference's own tests call: the reader's,
  writer's and phase log's methods, ``make_string_size``, the
  ``unique_words_device`` export, ``total_records``.

Pairs and counts are integers and bytes are bytes: every comparison is
exact.  The JAX side runs on the CPU as its own tests run it (its dense
scans through XLA; no Pallas kernel is reached here).
"""

import gzip
import os

import numpy as np
import pytest
import torch

from humid_tpu import words as JW
from humid_tpu.ops import hamming as JH
from humid_tpu.ops import neighbors as JN
from humid_tpu_torch import words as W
from humid_tpu_torch.ops import hamming as H
from humid_tpu_torch.ops import neighbors as N
from humid_tpu_torch.ops import runs_device as R
from humid_tpu_torch.ops import unique_words

from genfastq import gen_dataset


def _table(rng, length, n_pool, n_reads, max_subst):
    """Ascending unique packed table from a pool with substitutions."""
    pool = rng.integers(0, 4, (n_pool, length), dtype=np.uint8)
    codes = pool[rng.integers(0, n_pool, n_reads)]
    for _ in range(max_subst):
        hit = rng.random(n_reads) < 0.5
        codes[np.flatnonzero(hit), rng.integers(0, length, int(hit.sum()))] \
            = rng.integers(0, 4, int(hit.sum()), dtype=np.uint8)
    uniq, _, _, _ = unique_words(W.pack_words(codes), want_inverse=False)
    return uniq


def _assert_pairs(got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


# ------------------------------------------------ block functions, one-hot

#: Word lengths of the one-hot cases: one and two lanes with a ragged
#: last lane, and the longest word the route accepts (16 lanes).
LENGTHS = (24, 33, H.ONEHOT_MAX_L)


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("cap", [8, 4096])
def test_block_functions_match_reference(length, cap):
    """hamming_block_xor and hamming_block_mxu equal the JAX package's,
    padding and overflow count included; cap 8 overflows."""
    rng = np.random.default_rng(length + cap)
    m = 1 + length // 16
    uniq = _table(rng, length, 60, 400, m)
    rows, cols = uniq[:150], uniq[100:320]
    args = (rows, cols, 0, 100, m, cap)
    want = JH.hamming_block_xor(*args)
    assert int(want[2]) > 8  # the small cap overflows
    for got in (H.hamming_block_xor(*args, device="cpu"),
                H.hamming_block_mxu(*args, length, device="cpu")):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mxu = JH.hamming_block_mxu(*args, word_length=length)
    for g, w in zip(H.hamming_block_mxu(*args, length, device="cpu"), mxu):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_onehot_padding_columns_never_match():
    """The one-hot products pad the columns to a multiple of 32 rows of
    zeros; at ``max_dist = L`` every real pair matches (the threshold is
    0 matches) and the padding must still give none: 37 columns."""
    rng = np.random.default_rng(37)
    uniq = _table(rng, 24, 30, 200, 2)
    args = (uniq[:50], uniq[13:50], 0, 13, 24, 4096)
    want = JH.hamming_block_xor(*args)
    assert int(want[2]) == sum(range(13, 50))  # column c has c rows below
    for g, w in zip(H.hamming_block_mxu(*args, 24, device="cpu"), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fn", ["hamming_block_xor", "hamming_block_mxu"])
def test_block_functions_resolve_the_device(fn, monkeypatch):
    """Numpy input to a block function goes where every entry point goes:
    $HUMID_TPU_TORCH_DEVICE when set, else the card, which raises where
    there is none (no quiet CPU fallback); an explicit ``device`` wins,
    and a tensor stays on its own device."""
    from humid_tpu_torch._device import ENV_VAR
    from humid_tpu_torch.errors import DeviceUnavailableError

    rng = np.random.default_rng(3)
    uniq = _table(rng, 24, 20, 100, 1)
    call = getattr(H, fn)
    args = (uniq[:40], uniq[20:60], 0, 20, 1, 64) + (
        (24,) if fn == "hamming_block_mxu" else ())
    want = JH.hamming_block_xor(*args[:6])
    monkeypatch.setenv(ENV_VAR, "cpu")
    got = call(*args)
    assert got[0].device.type == "cpu"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    lanes = (H.lanes_tensor(uniq[:40], "cpu"), H.lanes_tensor(uniq[20:60],
                                                              "cpu"))
    monkeypatch.delenv(ENV_VAR)
    assert call(*lanes, *args[2:])[0].device.type == "cpu"
    assert call(*args, device="cpu")[0].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            call(*args)
        monkeypatch.setenv(ENV_VAR, "cuda")
        with pytest.raises(DeviceUnavailableError):
            call(*args)


@pytest.mark.parametrize("length", LENGTHS)
def test_onehot_bases_match_reference(length):
    """The one-hot encoding equals the reference's ``onehot_bases`` on its
    4L columns; both pad with zeros (to 32 columns here, 128 there)."""
    rng = np.random.default_rng(length)
    uniq = _table(rng, length, 30, 200, 2)
    want = np.asarray(JN.onehot_bases(uniq, length), np.float32)
    got = H.onehot_bases(H.lanes_tensor(uniq, "cpu"), length).numpy()
    assert got.shape[1] % 32 == 0 and got.shape[1] >= 4 * length
    np.testing.assert_array_equal(got[:, :4 * length],
                                  want[:, :4 * length])
    assert not got[:, 4 * length:].any() and not want[:, 4 * length:].any()


def test_onehot_exactness_bound():
    """A bf16 product holds integers exactly only up to 256 (8 significant
    bits), and a match count reaches L: so the route takes L <= 256.  At
    L = 256 identical words count 256 matches exactly; 257 is not a bf16
    value; longer words and a missing length raise."""
    assert H.ONEHOT_MAX_L == 256
    assert torch.tensor(257.0, dtype=torch.bfloat16).item() != 257.0
    assert torch.tensor(256.0, dtype=torch.bfloat16).item() == 256.0
    rng = np.random.default_rng(256)
    words = W.pack_words(rng.integers(0, 4, (40, 256), dtype=np.uint8))
    oh = H.onehot_bases(H.lanes_tensor(words, "cpu"), 256,
                        dtype=torch.bfloat16)
    diag = torch.diagonal((oh @ oh.t()).float())
    assert (diag == 256).all()
    lanes = H.lanes_tensor(np.zeros((64, 17), np.uint32), "cpu")
    tp = torch.tensor([[0, 0, 1]], dtype=torch.int32)
    kw = dict(tile=64, part_stride=64, part_valid=64, max_dist=1)
    with pytest.raises(ValueError, match="at most 256"):
        H.onehot_tile_pairs(lanes, tp, word_length=257, **kw)
    with pytest.raises(ValueError, match="requires word_length"):
        N.find_neighbor_pairs(words, 1, strategy="dense", impl="mxu",
                              device="cpu")


@pytest.mark.parametrize("length,m", [(24, 1), (33, 2), (H.ONEHOT_MAX_L, 3)])
def test_dense_impls_match_reference_mxu(length, m):
    """The dense engine under every ``impl`` (the one-hot route, the plain
    version, K1's wrapper) and the one-hot route alone equal the JAX
    package's dense ``impl="mxu"`` and ``impl="xor"`` scans."""
    rng = np.random.default_rng(length * 10 + m)
    uniq = _table(rng, length, 80, 700, m + 1)
    want = JN.find_neighbor_pairs(uniq, m, word_length=length,
                                  strategy="dense", impl="mxu", tile=256)
    assert len(want[0])
    _assert_pairs(JN.find_neighbor_pairs(uniq, m, word_length=length,
                                         strategy="dense", impl="xor",
                                         tile=256), want)
    for impl in ("xor", "pallas", "mxu"):
        info = {}
        _assert_pairs(N.find_neighbor_pairs(
            uniq, m, word_length=length, strategy="dense", impl=impl,
            tile=256, device="cpu", info=info), want)
        assert info["impl"] == impl
    rows, tps, b, u_pad = N.dense_inputs(uniq, 256)
    lanes, tp = N.sweep_tensors(rows, tps, "cpu")
    kw = dict(tile=b, part_stride=u_pad, part_valid=len(uniq), max_dist=m)
    a, bb = H.onehot_tile_pairs(lanes, tp, word_length=length, **kw)
    _assert_pairs((a.numpy(), bb.numpy()), want)


@pytest.mark.parametrize("impl", ["xor", "pallas", "mxu"])
@pytest.mark.parametrize("engine", ["dense", "bucketed", "runs",
                                    "runs_device"])
def test_every_engine_under_every_impl(engine, impl, monkeypatch):
    """Each engine that sweeps tiles takes ``impl`` to its sweep: the
    dense and bucketed sweeps, and the big-run sweep of both runs engines
    (run_cap 12, as the port's fused mirrors use, so that big runs exist:
    asserted); all equal the JAX package's host runs engine."""
    rng = np.random.default_rng(91)
    uniq = _table(rng, 24, 12, 2500, 2)  # few templates: long runs
    want = JN.find_neighbor_pairs(uniq, 1, word_length=24, strategy="runs")
    impls = []
    real = N.sweep

    def spy(*args, **kw):
        impls.append(kw["impl"])
        return real(*args, **kw)

    monkeypatch.setattr(N, "sweep", spy)
    info = {}
    if engine in ("runs", "runs_device"):
        fn = (N.find_neighbor_pairs_runs if engine == "runs"
              else R.runs_device_pairs)
        got = fn(uniq, 1, word_length=24, run_cap=12, tile=256, impl=impl,
                 device="cpu", info=info)
        assert info["dense_fallbacks"] == 0
    else:
        got = N.find_neighbor_pairs(uniq, 1, word_length=24, tile=256,
                                    strategy=engine, impl=impl,
                                    device="cpu", info=info)
        assert info == {"metric": "hamming", "strategy": engine,
                        "impl": impl}
    _assert_pairs(got, want)
    assert impls and set(impls) == {impl}


def test_impl_env_and_explicit_argument(monkeypatch):
    """$HUMID_TPU_TORCH_IMPL replaces ``impl=None``, an explicit argument
    wins, a bad name raises; with no impl the record holds none."""
    rng = np.random.default_rng(5)
    uniq = _table(rng, 24, 50, 400, 2)
    want = JN.find_neighbor_pairs(uniq, 1, word_length=24, strategy="dense")
    for env, arg, ran in (("mxu", None, "mxu"), ("mxu", "xor", "xor"),
                          (None, None, None)):
        with monkeypatch.context() as mp:
            if env:
                mp.setenv(N.IMPL_ENV_VAR, env)
            else:
                mp.delenv(N.IMPL_ENV_VAR, raising=False)
            info = {}
            _assert_pairs(N.find_neighbor_pairs(
                uniq, 1, word_length=24, strategy="dense", impl=arg,
                device="cpu", info=info), want)
            assert info.get("impl") == ran
    with pytest.raises(ValueError, match="unknown impl"):
        N.find_neighbor_pairs(uniq, 1, word_length=24, impl="tpu",
                              device="cpu")


def test_pallas_ring_names():
    """The reference's names for the ring route: ``strategy="pallas_ring"``
    and ``impl="pallas_ring"`` under "sharded" run the ring (K2's route),
    and ``sharded_neighbor_pairs_pallas_ring`` is the port's ring."""
    from humid_tpu_torch import parallel as P

    assert P.sharded_neighbor_pairs_pallas_ring is \
        P.sharded_neighbor_pairs_ring
    rng = np.random.default_rng(17)
    uniq = _table(rng, 24, 40, 600, 2)
    want = JN.find_neighbor_pairs(uniq, 1, word_length=24, strategy="dense")
    mesh = P.data_mesh(3, "cpu")
    for kw in ({"strategy": "pallas_ring"},
               {"strategy": "sharded", "impl": "pallas_ring"}):
        info = {}
        _assert_pairs(N.find_neighbor_pairs(uniq, 1, word_length=24,
                                            mesh=mesh, device="cpu",
                                            runs_threshold=64, info=info,
                                            **kw), want)
        assert info["strategy"] == "ring" and info["ring_fallbacks"] == 0
        assert info.get("impl") == kw.get("impl")


#: (find_neighbor_pairs options, what makes the route, the impl recorded):
#: a tile-sweep impl is recorded only where a tile sweep produced the
#: pairs; where the ring ran, "pallas_ring" (as in the reference, a
#: tile-sweep impl does not apply to the ring).
RING_ROUTE_CASES = [
    ({"strategy": "ring", "impl": "mxu"}, None, "pallas_ring"),
    ({"strategy": "sharded", "impl": "xor"}, None, "pallas_ring"),
    ({"strategy": "sharded", "impl": "mxu", "runs_threshold": 64}, None,
     "mxu"),
    ({"strategy": "sharded_bucketed", "impl": "pallas_ring"}, None,
     "pallas"),
    ({"strategy": "ring", "impl": "mxu"}, "ring_limit", "mxu"),
    ({"strategy": "ring", "impl": "pallas_ring"}, "ring_limit", "pallas"),
    ({"strategy": "sharded_bucketed", "impl": "mxu"}, "giant_runs",
     "pallas_ring"),
]


@pytest.mark.parametrize("opts,force,recorded", RING_ROUTE_CASES)
def test_impl_record_follows_the_route_that_ran(opts, force, recorded,
                                                monkeypatch):
    """``info["impl"]`` names what produced the pairs under the mesh
    strategies: the ring, the dense ring under "sharded" (at most
    ``runs_threshold`` uniques), the bucketed mesh search, the ring's
    fallback to the dense sweep (the sweep runs the asked impl) and the
    bucketed search's giant-run fallback to the ring."""
    from humid_tpu_torch import parallel as P
    from humid_tpu_torch.parallel import neighbors as PN

    rng = np.random.default_rng(29)
    uniq = _table(rng, 24, 40, 600, 2)
    want = JN.find_neighbor_pairs(uniq, 1, word_length=24, strategy="dense")
    swept = []
    real = N.sweep
    for module in (N, PN):  # the bucketed mesh search imports it by name
        monkeypatch.setattr(module, "sweep", lambda *a, **kw: (
            swept.append(kw["impl"]), real(*a, **kw))[1])
    if force == "ring_limit":
        def over(*a, **kw):
            raise P.RingLimitExceeded("forced")
        monkeypatch.setattr(P, "sharded_neighbor_pairs_ring", over)
    if force == "giant_runs":
        def giant(*a, **kw):
            raise PN.GiantRuns("forced")
        monkeypatch.setattr(PN, "bucketed_shard_inputs", giant)
    info = {}
    _assert_pairs(N.find_neighbor_pairs(
        uniq, 1, word_length=24, mesh=P.data_mesh(3, "cpu"), device="cpu",
        info=info, **opts), want)
    assert info["impl"] == recorded
    assert info["ring_fallbacks"] == (force == "ring_limit")
    if recorded == "pallas_ring":
        assert not swept
    else:
        assert swept and set(swept) == {opts["impl"]}


@pytest.mark.parametrize("impl", ["pallas", "mxu"])
def test_cap_total_is_the_first_capacity(impl):
    """``cap_total`` is only the key buffer's first capacity: a capacity of
    one pair overflows and grows, and the pairs are those of the default
    capacity (the reference's retry loop, ``_extract_with_retry``)."""
    rng = np.random.default_rng(23)
    uniq = _table(rng, 24, 40, 800, 2)
    want = N.find_neighbor_pairs(uniq, 1, word_length=24, strategy="dense",
                                 device="cpu")
    assert len(want[0]) > 1
    for cap in (1, 1 << 20):
        _assert_pairs(N.find_neighbor_pairs(
            uniq, 1, word_length=24, strategy="dense", impl=impl,
            cap_total=cap, device="cpu"), want)


# ---------------------------------------------------- the opt-in routes' gates

class _FakeNative:
    """Stands in for the clustering extension: records the walk asked
    for and runs the Python walk (the extension is not built here)."""

    def __init__(self, module):
        self.module = module
        self.walks = []

    def cluster(self, counts, indptr, indices, maximum, parallel=False):
        self.walks.append(parallel)
        res = (self.module._cluster_max_py if maximum
               else self.module._cluster_directional_py)(counts, indptr,
                                                         indices)
        return res.labels, res.max_leaf, res.max_count, res.size


@pytest.mark.parametrize("parallel", [None, True, False])
@pytest.mark.parametrize("env", [None, "parallel", "seq", "device"])
def test_cluster_walk_gate_matches_reference(parallel, env, monkeypatch):
    """Which native walk ``cluster_exact`` asks for, for every ``parallel=``
    and $HUMID_TPU_TORCH_CLUSTER (the reference's HUMID_TPU_CLUSTER): the
    same as the JAX package's gate; never parallel by default."""
    from humid_tpu.cluster import exact as JX
    from humid_tpu_torch.cluster import exact as X

    counts = np.array([5, 7, 2, 3], np.int64)
    indptr = np.array([0, 1, 2, 3, 4], np.int64)
    indices = np.array([2, 3, 0, 1], np.int64)
    walks = {}
    for name, mod, var in (("port", X, "HUMID_TPU_TORCH_CLUSTER"),
                           ("ref", JX, "HUMID_TPU_CLUSTER")):
        fake = _FakeNative(mod)
        monkeypatch.setattr(mod, "_native", fake)
        if env is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, env)
        res = mod.cluster_exact(counts, indptr, indices, parallel=parallel)
        assert res.labels.tolist() == [1, 2, 1, 2]
        walks[name] = fake.walks
    assert walks["port"] == walks["ref"]
    assert walks["port"] == [parallel if parallel is not None
                             else env == "parallel"]


@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("env", [None, "1", "0"])
@pytest.mark.parametrize("built", [True, False])
def test_overlap_gate(w, env, built, monkeypatch):
    """The overlapped pass 1 + unique route engages only when asked for
    (=1), for words of at most two lanes, with both host extensions: the
    reference's gate (``humid_tpu/pipeline.py:546-558``)."""
    from humid_tpu_torch import pipeline as P

    monkeypatch.setattr(P, "_merge_unique_runs", object() if built else None)
    monkeypatch.setattr(P, "_encode_pack", object() if built else None)
    if env is None:
        monkeypatch.delenv(P.OVERLAP_ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(P.OVERLAP_ENV_VAR, env)
    assert P.overlap_unique(w) == (env == "1" and w <= 2 and built)


def _fastq(tmp_path, seed=57, n_reads=400):
    gen_dataset(np.random.default_rng(seed), str(tmp_path), n_reads=n_reads,
                n_files=1, umi_style="none")
    return [str(tmp_path / "file0.fastq")]


def test_optins_that_cannot_engage_keep_the_fused_route(tmp_path,
                                                        monkeypatch):
    """With the fused route forced, an overlap opt-in that cannot engage
    (no host extensions, as here) keeps the fused route, while a set
    $HUMID_TPU_TORCH_IMPL or an ``impl`` in ``neighbor_opts`` leaves it,
    as the reference's gate does (``pipeline.py:551-554``); the outputs
    are the same bytes every time."""
    import humid_tpu_torch
    from humid_tpu_torch import pipeline as P

    files = _fastq(tmp_path)
    monkeypatch.setattr(P, "_merge_unique_runs", None)
    monkeypatch.setenv("HUMID_TPU_TORCH_FUSED", "1")
    outs = {}
    for name, env, opts, fused in (
            ("overlap", {P.OVERLAP_ENV_VAR: "1"}, None, True),
            ("impl_env", {N.IMPL_ENV_VAR: "mxu"}, None, False),
            ("impl_opt", {}, {"impl": "mxu"}, False)):
        with monkeypatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            res = humid_tpu_torch.run(files, dir_name=str(tmp_path / name),
                                      log_name=os.devnull, device="cpu",
                                      neighbor_opts=opts)
        assert (res.extra["engine"]["unique"] == "fused") == fused, name
        if not fused:
            assert res.extra["engine"]["impl"] == "mxu"
        outs[name] = (tmp_path / name / "file0_dedup.fastq").read_bytes()
    assert outs["overlap"] == outs["impl_env"] == outs["impl_opt"]


def test_cluster_dispatch_device_threshold(monkeypatch):
    """``device_threshold`` (the reference's) is the size above which -x
    asks for device components; both routes give the host walk's
    clusters."""
    from humid_tpu_torch import _backend
    from humid_tpu_torch.cluster import cluster_exact
    from humid_tpu_torch.pipeline import cluster_dispatch

    rng = np.random.default_rng(3)
    uniq = _table(rng, 16, 30, 300, 2)
    counts = rng.integers(1, 9, len(uniq)).astype(np.int64)
    pa, pb = N.find_neighbor_pairs(uniq, 1, word_length=16,
                                   strategy="dense", device="cpu")
    indptr, indices = N.pairs_to_csr(pa, pb, len(uniq))
    want = cluster_exact(counts, indptr, indices, maximum=True)
    monkeypatch.setattr(_backend, "use_device_engine", lambda *a: True)
    for threshold, route in ((0, "device"), (len(uniq), "host")):
        info = {}
        got = cluster_dispatch(counts, indptr, indices, maximum=True,
                               pairs=(pa, pb), device_threshold=threshold,
                               device=torch.device("cpu"), info=info)
        assert info["components"] == route
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.max_leaf, want.max_leaf)


# ------------------------------------------------------- I/O and helpers

def _reader_records(reader_cls, path, workers, chunk_bytes):
    r = reader_cls(path, chunk_bytes=chunk_bytes, frame_workers=workers)
    return [b.record_bytes(i) for b in r.records() for i in range(b.n)]


def _both_readers(path, workers, chunk_bytes):
    from humid_tpu.io.reader import FastqReader as JReader
    from humid_tpu_torch.io.reader import FastqReader

    got = _reader_records(FastqReader, path, workers, chunk_bytes)
    assert got == _reader_records(JReader, path, workers, chunk_bytes)
    return got


@pytest.mark.parametrize("chunk_bytes", [97, 1024, 1 << 15])
def test_crlf_and_ragged_framing(tmp_path, chunk_bytes):
    """Random records (CRLF mixed in, huge and tiny reads) framed in
    chunks of every size, by one and by three framing workers: the port's
    records equal the JAX package's, byte for byte."""
    rng = np.random.default_rng(chunk_bytes)
    recs = []
    for i in range(400):
        nl = b"\r\n" if i % 5 == 0 else b"\n"
        seq = bytes(rng.choice(list(b"ACGTN"), int(rng.integers(1, 700))))
        recs.append(nl.join([b"@r%d desc" % i, seq, b"+",
                             b"I" * len(seq)]) + nl)
    p = tmp_path / "fuzz.fastq"
    p.write_bytes(b"".join(recs))
    for workers in (1, 3):
        assert len(_both_readers(str(p), workers, chunk_bytes)) == 400


def test_record_larger_than_chunk(tmp_path):
    seq = b"A" * 5000
    rec = b"@big\n" + seq + b"\n+\n" + b"I" * 5000 + b"\n"
    small = b"@s\nACGT\n+\nIIII\n"
    p = tmp_path / "big.fastq"
    p.write_bytes(small + rec + small)
    assert _both_readers(str(p), 3, 256) == [small, rec, small]


@pytest.mark.parametrize("members", [1, 40])
def test_gzip_oneshot_streaming_and_members(tmp_path, members):
    """A gzip file of one member or of many (as the writers make them):
    every framing path of the port equals the JAX package's records and
    the plain file's."""
    rng = np.random.default_rng(members)
    recs = []
    for i in range(500):
        seq = bytes(rng.choice(list(b"ACGT"), int(rng.integers(5, 200))))
        recs.append(b"\n".join([b"@g%d" % i, seq, b"+", b"F" * len(seq)])
                    + b"\n")
    p = tmp_path / "t.fastq.gz"
    step = -(-len(recs) // members)
    p.write_bytes(b"".join(gzip.compress(b"".join(recs[i:i + step]))
                           for i in range(0, len(recs), step)))
    for workers in (1, 4):
        assert _both_readers(str(p), workers, 1 << 14) == recs


def test_skip_to_record_offsets(tmp_path):
    from humid_tpu.io import skip_to_record as j_skip
    from humid_tpu_torch.io import read_tuples
    from humid_tpu_torch.io.reader import skip_to_record

    recs = [f"@r{i}\nACGTAC\n+\nIIIIII\n".encode() for i in range(37)]
    p = tmp_path / "x.fastq"
    p.write_bytes(b"".join(recs))
    for k in (0, 1, 5, 36, 38):
        assert skip_to_record(str(p), k) == j_skip(str(p), k)
    for k in (0, 5, 36):
        off = skip_to_record(str(p), k)
        names = [b.line_bytes(i, 0) for (b,) in read_tuples(
            [str(p)], start_offsets=[off]) for i in range(b.n)]
        assert names == [f"@r{i}".encode() for i in range(k, 37)]
    g = tmp_path / "x.fastq.gz"
    g.write_bytes(gzip.compress(p.read_bytes()))
    assert skip_to_record(str(g), 3) is None is j_skip(str(g), 3)


def test_hostile_bytes_encode_matches_reference():
    """Every width, and bytes that are no base (NUL, 0xFF, lowercase,
    '@'): the port's words and filter flags equal the JAX package's."""
    rng = np.random.default_rng(11)
    alphabet = np.frombuffer(b"ACGTNacgtX\0\xff@", np.uint8)
    for length in (1, 8, 15, 16, 17, 24, 33, 48):
        chars = np.ascontiguousarray(rng.choice(
            alphabet, size=(int(rng.integers(1, 700)), length)))
        codes, filt = W.build_words(None, [chars])
        jcodes, jfilt = JW.build_words(None, [chars])
        np.testing.assert_array_equal(filt, jfilt)
        np.testing.assert_array_equal(W.pack_words(codes),
                                      JW.pack_words(jcodes))


def test_umi_batch_matches_scalar_and_reference():
    rng = np.random.default_rng(42)
    pool = ["header", "h_ACGT", "x:ACGT", "a_b_c_GATTACA", "@inst:1:2:ACGT",
            "read one_ACGT", "plain", "x_acgt", "y:NNNN", "z_ACGTN", "q_A",
            "_ACGT", ":TTTT", "a_ b:CCC", "@1:::::::AGTA",
            "s_TTTT extra:GGGG", "", "A", "_", ":", "a__TTTT", "x_:GG"]
    headers = [pool[i] for i in rng.integers(0, len(pool), 500)]
    raw = [h.encode() for h in headers]
    for umi_size in (0, 1, 3, 4, 8):
        batch = W.extract_umi_batch(raw, umi_size)
        np.testing.assert_array_equal(batch,
                                      JW.extract_umi_batch(raw, umi_size))
        for row, h in zip(batch, headers):
            assert row.tobytes().decode() == W.make_string_size(
                W.extract_umi(h), umi_size)


@pytest.mark.parametrize("s,size,padding", [
    ("ACGT", 2, "N"), ("ACGT", 4, "N"), ("AC", 5, "N"), ("", 3, "x"),
    ("ACGT", 0, "N")])
def test_make_string_size_matches_reference(s, size, padding):
    assert W.make_string_size(s, size, padding) == \
        JW.make_string_size(s, size, padding)


@pytest.mark.parametrize("w", [1, 2, 3])
def test_unique_words_device_matches_host_and_reference(w):
    """The ``ops`` export ``unique_words_device`` (on the CPU device here)
    equals the host unique counting and the JAX package's, at sizes that
    cross padding boundaries, and keeps an all-ones word apart."""
    from humid_tpu.ops import unique_words as j_unique
    from humid_tpu_torch import ops

    assert "unique_words_device" in ops.__all__
    rng = np.random.default_rng(123 + w)
    for n in (1, 7, 100, 1000, 4097):
        packed = rng.integers(0, 5, size=(n, w)).astype(np.uint32)
        host = ops.unique_words(packed, want_inverse=True)
        dev = ops.unique_words_device(packed, want_inverse=True,
                                      device="cpu")
        ref = j_unique(packed, want_inverse=True)
        for x, y, z in zip(host, dev, ref):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
    dev = ops.unique_words_device(np.full((8, w), 0xFFFFFFFF, np.uint32),
                                  device="cpu")
    assert len(dev[1]) == 1 and dev[1][0] == 8


def test_phaselog_phase_on_a_raising_body(tmp_path):
    """``PhaseLog.phase``: a body that raises writes "failed.", records the
    phase's time, closes the profiler range and lets the exception go on;
    the log text equals the JAX package's."""
    from humid_tpu.phaselog import PhaseLog as JLog
    from humid_tpu_torch.phaselog import PhaseLog

    texts = []
    for cls, name in ((PhaseLog, "port.log"), (JLog, "ref.log")):
        log = cls(str(tmp_path / name))
        with log.phase("Good"):
            pass
        with pytest.raises(KeyError):
            with log.phase("Bad"):
                raise KeyError("x")
        log.close()
        assert [t[0] for t in log.timings] == ["Good", "Bad"]
        texts.append((tmp_path / name).read_text())
        if cls is PhaseLog:
            assert log._range is None and log._current is None
    assert texts[0] == texts[1] == ("Good... done. (0m0s)\n"
                                    "Bad... failed.\n")


@pytest.mark.parametrize("suffix", ["fastq", "fastq.gz"])
def test_writer_methods_match_reference(tmp_path, suffix):
    """``FastqWriter.write_records`` / ``write_records_annotated`` and its
    context manager write the JAX package's bytes (gzip by decompressed
    content)."""
    from humid_tpu.io.reader import FastqReader as JReader
    from humid_tpu.io.writer import FastqWriter as JWriter
    from humid_tpu_torch.io.reader import FastqReader
    from humid_tpu_torch.io.writer import FastqWriter

    files = _fastq(tmp_path, seed=8, n_reads=120)
    out = {}
    for name, reader, writer in (("port", FastqReader, FastqWriter),
                                 ("ref", JReader, JWriter)):
        (batch,) = list(reader(files[0]).records())
        sel = np.arange(0, batch.n, 3)
        ids = np.arange(batch.n, dtype=np.int64) % 7
        path = tmp_path / f"{name}.{suffix}"
        with writer(str(path)) as w:
            w.write_records(batch, sel)
            w.write_records_annotated(batch, ids)
        data = path.read_bytes()
        out[name] = gzip.decompress(data) if suffix.endswith("gz") else data
    assert out["port"] == out["ref"] and out["port"].count(b"\n") == \
        4 * (len(range(0, 120, 3)) + 120)


@pytest.mark.parametrize("gz", [False, True])
def test_total_records_skips_the_count(tmp_path, gz, monkeypatch):
    """``run_sharded(total_records=)`` and ``run_distributed(
    total_records=)`` (two processes in threads) skip the count scan and
    give the results and bytes of the runs that count; plain files take
    their offsets by a newline scan, gzip files are spilled."""
    import threading

    from humid_tpu_torch.parallel import pipeline as PP

    gen_dataset(np.random.default_rng(31), str(tmp_path), n_reads=600,
                n_files=2, umi_style="underscore", gz=gz)
    ext = ".fastq.gz" if gz else ".fastq"
    files = [str(tmp_path / f"file{i}{ext}") for i in range(2)]
    total = PP.count_records(files)
    want = PP.run_sharded(files, device="cpu")
    got = PP.run_sharded(files, total_records=total, device="cpu")
    for x, y in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(want[0].labels, got[0].labels)

    monkeypatch.setattr(PP, "count_records_with_tables",
                        lambda f: pytest.fail("counted"))
    slots, barrier = [None, None], threading.Barrier(2, timeout=120)

    def gather_for(p):
        def gather(arrs):
            slots[p] = [np.array(a) for a in arrs]
            barrier.wait()
            out = [[slots[q][i] for q in range(2)] for i in range(len(arrs))]
            barrier.wait()
            return out
        return gather

    errors = []

    def host(p):
        try:
            PP.run_distributed(files, dir_name=str(tmp_path / "mp"),
                               log_name=os.devnull, process_id=p,
                               num_processes=2, total_records=total,
                               all_gather=gather_for(p),
                               barrier=barrier.wait, device="cpu")
        except BaseException as exc:
            errors.append(exc)
            barrier.abort()

    threads = [threading.Thread(target=host, args=(p,)) for p in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    import humid_tpu_torch

    humid_tpu_torch.run(files, dir_name=str(tmp_path / "one"),
                        log_name=os.devnull, device="cpu")
    for f in sorted(os.listdir(tmp_path / "one")):
        a = (tmp_path / "one" / f).read_bytes()
        b = (tmp_path / "mp" / f).read_bytes()
        if f.endswith(".gz"):
            a, b = gzip.decompress(a), gzip.decompress(b)
        assert a == b, f
