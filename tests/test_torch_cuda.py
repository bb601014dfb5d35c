"""Tests of humid_tpu_torch that need a CUDA card (``cuda`` marker): the
hand-written Hamming sweep and ring kernels against their plain PyTorch
versions on the card, the banded-Levenshtein programs and the neighbour
engines of both metrics (the multi-stream rings and the pigeonhole runs
engines included) on the card against the CPU, device unique counting and
the fused device-resident route against the CPU (with the host waits it
may make and the reuse of its pinned staging buffers), the device
directional clustering against the CPU (one host wait a round) and
through run() against the default route, and the CLI on the card
against baseline/humid_ref.

They skip where torch.cuda.is_available() is False.  This file imports no
jax, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Everything compared is integer or byte data: exact equality throughout.
"""

import gzip
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from humid_tpu_torch import words as W
from humid_tpu_torch.cluster import connected_components_device
from humid_tpu_torch.ops import cuda_hamming as K
from humid_tpu_torch.ops import edit as E
from humid_tpu_torch.ops import fused as F
from humid_tpu_torch.ops import neighbors as N
from humid_tpu_torch.ops import runs_device as RD
from humid_tpu_torch.ops import unique as U
from humid_tpu_torch.ops import unique_words
from humid_tpu_torch import parallel as P
from humid_tpu_torch.parallel import cuda_ring as R

sys.path.insert(0, os.path.dirname(__file__))
from genfastq import gen_dataset  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _words(rng, n, length, pool=200):
    base = rng.integers(0, 4, (pool, length), dtype=np.uint8)
    codes = base[rng.integers(0, pool, n)]
    mut = rng.random(n) < 0.6
    codes[np.flatnonzero(mut), rng.integers(0, length, int(mut.sum()))] = (
        rng.integers(0, 4, int(mut.sum()), dtype=np.uint8))
    return W.pack_words(codes)


def _tensors(rows, pairs, device, on=None):
    tp = np.ones((len(pairs), 3), np.int32)
    tp[:, :2] = pairs
    if on is not None:
        tp[:, 2] = on
    return (torch.from_numpy(rows.view(np.int32)).to(device),
            torch.from_numpy(tp).to(device))


def _upper_pairs(t):
    ii, jj = np.triu_indices(t)
    return np.stack([ii, jj], axis=1)


@pytest.mark.parametrize("length", [14, 24, 40, 256])
def test_kernel_matches_plain(length, cuda_device):
    """Kernel == plain on the card, twice (the atomic append order must
    not leak into the sorted output), with padding rows, disabled tile
    pairs, diagonal and off-diagonal tile pairs and a ragged last tile."""
    rng = np.random.default_rng(200 + length)
    rows = _words(rng, 4000, length)
    pairs = _upper_pairs(8)
    on = (np.arange(len(pairs)) % 5 != 3).astype(np.int32)
    lanes, tp = _tensors(rows, pairs, cuda_device, on)
    kw = dict(tile=512, part_stride=2048, part_valid=1900, max_dist=2)
    pa, pb = K.hamming_tile_pairs_plain(lanes, tp, **kw)
    assert len(pa) > 0
    launches = K.LAUNCHES
    for _ in range(2):
        a, b = K.hamming_tile_pairs(lanes, tp, **kw)
        assert torch.equal(a, pa) and torch.equal(b, pb)
    assert K.LAUNCHES == launches + 2


@pytest.mark.parametrize("tile", [256, 512, 2048])
@pytest.mark.parametrize("length", [14, 24, 40, 72, 256])  # w = 1, 2, 3, 5, 16
def test_kernel_matches_plain_by_width_and_tile(length, tile, cuda_device):
    """Kernel == plain for odd and even lane counts (an odd count leaves
    the last bit-plane word half empty) at the tiles in use: 256 and 512
    are smaller than a full block of threads, 2048 takes several row
    blocks and column spans.  Two partitions with padding between them."""
    rng = np.random.default_rng(500 + length + tile)
    rows = _words(rng, 8192, length, pool=400)
    rows[3900:4096] = 0
    rows[7996:] = 0
    lanes, tp = _tensors(rows, _upper_pairs(8192 // tile)[::3], cuda_device)
    kw = dict(tile=tile, part_stride=4096, part_valid=3900, max_dist=2)
    pa, pb = K.hamming_tile_pairs_plain(lanes, tp, **kw)
    assert len(pa) > 0 and int((pb % 4096).max()) < 3900
    a, b = K.hamming_tile_pairs(lanes, tp, **kw)
    assert torch.equal(a, pa) and torch.equal(b, pb)


@pytest.mark.parametrize("stride,valid", [(1300, 1100), (700, 256)])
def test_kernel_stride_not_a_multiple_of_the_tile(stride, valid,
                                                  cuda_device):
    """A part_stride that the tile does not divide: the valid rows of a
    tile are no prefix, and the kernel tests the index of every pair that
    passes the distance test."""
    rng = np.random.default_rng(stride)
    rows = _words(rng, 4000, 24, pool=100)
    rows[rng.random(4000) < 0.2] = 0  # zero words among the real ones
    lanes, tp = _tensors(rows, _upper_pairs(8), cuda_device)
    kw = dict(tile=512, part_stride=stride, part_valid=valid, max_dist=2)
    pa, pb = K.hamming_tile_pairs_plain(lanes, tp, **kw)
    assert len(pa) > 0
    for _ in range(2):
        a, b = K.hamming_tile_pairs(lanes, tp, **kw)
        assert torch.equal(a, pa) and torch.equal(b, pb)


def test_kernel_takes_more_than_65535_tile_pairs(cuda_device, monkeypatch):
    """67,896 tile pairs of 256 rows in one launch (the work list is one
    grid dimension) == the plain version over the same table at tile
    2048 (1,081 tile pairs): both cover every unordered pair once."""
    rng = np.random.default_rng(65)
    n = 46 * 2048
    rows = _words(rng, n, 16, pool=3000)
    kw = dict(part_stride=n, part_valid=n, max_dist=1)
    lanes, tp = _tensors(rows, _upper_pairs(n // 2048), cuda_device)
    pa, pb = K.hamming_tile_pairs_plain(lanes, tp, tile=2048, **kw)
    lanes, tp = _tensors(rows, _upper_pairs(n // 256), cuda_device)
    assert len(tp) > 65535 and len(pa) > 0
    monkeypatch.setattr(K, "CHUNK_PAIRS", 1 << 17)
    monkeypatch.setattr(K, "CAP_START", max(K.CAP_START, len(pa)))
    launches = K.LAUNCHES
    a, b = K.hamming_tile_pairs(lanes, tp, tile=256, **kw)
    assert K.LAUNCHES == launches + 1
    assert torch.equal(a, pa) and torch.equal(b, pb)


@pytest.mark.parametrize("bad", [(1, 0), (-1, 0)])
def test_kernel_flags_a_bad_tile_pair(bad, cuda_device):
    """tj < ti or a negative tile: the kernel raises its flag and the
    wrapper raises ValueError after its one read-back, also when the pair
    is disabled; the plain version raises too."""
    rows = _words(np.random.default_rng(9), 1024, 24)
    lanes, tp = _tensors(rows, np.array([(0, 0), bad, (0, 1)]), cuda_device,
                         on=np.array([1, 0, 1], np.int32))
    kw = dict(tile=512, part_stride=1024, part_valid=1024, max_dist=1)
    launches = K.LAUNCHES
    with pytest.raises(ValueError, match="0 <= ti <= tj"):
        K.hamming_tile_pairs(lanes, tp, **kw)
    assert K.LAUNCHES == launches + 1  # found by the kernel, not before it
    with pytest.raises(ValueError, match="0 <= ti <= tj"):
        K.hamming_tile_pairs_plain(lanes, tp, **kw)


@pytest.mark.parametrize("cap_start", [1 << 23, 8])
def test_kernel_one_read_back_per_launch(cap_start, cuda_device,
                                         monkeypatch):
    """hamming_tile_pairs reads the device once per launch (the counter
    words, through _read_back) and synchronises nowhere else: every other
    synchronising call raises under the sync debug mode.  With a tiny
    first buffer every chunk is launched twice."""
    rng = np.random.default_rng(12)
    rows = _words(rng, 4096, 24, pool=40)
    lanes, tp = _tensors(rows, _upper_pairs(8), cuda_device)
    kw = dict(tile=512, part_stride=4096, part_valid=4096, max_dist=1)
    pa, pb = K.hamming_tile_pairs_plain(lanes, tp, **kw)
    K.hamming_tile_pairs(lanes, tp, **kw)  # build and load the kernel
    reads = []
    real = K._read_back

    def counting(counter):  # the one place that may wait for the device
        reads.append(1)
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real(counter)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(K, "_read_back", counting)
    monkeypatch.setattr(K, "CAP_START", cap_start)
    monkeypatch.setattr(K, "CHUNK_PAIRS", 16)
    launches = K.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        a, b = K.hamming_tile_pairs(lanes, tp, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(a, pa) and torch.equal(b, pb)
    n_chunks = -(-len(tp) // 16)
    assert K.LAUNCHES - launches == len(reads)
    assert len(reads) == (n_chunks if cap_start > 8 else 2 * n_chunks)


def test_kernel_capacity_retry_and_split(cuda_device, monkeypatch):
    rng = np.random.default_rng(7)
    rows = _words(rng, 4096, 24, pool=20)
    lanes, tp = _tensors(rows, _upper_pairs(8), cuda_device)
    kw = dict(tile=512, part_stride=4096, part_valid=4096, max_dist=2)
    pa, pb = K.hamming_tile_pairs_plain(lanes, tp, **kw)
    monkeypatch.setattr(K, "CAP_START", 8)
    monkeypatch.setattr(K, "MAX_CAP", 4096)
    monkeypatch.setattr(K, "CHUNK_PAIRS", 5)
    launches = K.LAUNCHES
    a, b = K.hamming_tile_pairs(lanes, tp, **kw)
    assert torch.equal(a, pa) and torch.equal(b, pb)
    assert K.LAUNCHES - launches > len(tp) // 5 + 1  # relaunches happened


def test_kernel_max_dist_beyond_word_length(cuda_device):
    rows = np.zeros((1024, 1), np.uint32)
    rows[:700] = _words(np.random.default_rng(3), 700, 16)
    lanes, tp = _tensors(rows, _upper_pairs(2), cuda_device)
    a, b = K.hamming_tile_pairs(lanes, tp, tile=512, part_stride=1024,
                                part_valid=700, max_dist=20)
    ii, jj = np.triu_indices(700, k=1)
    np.testing.assert_array_equal(a.cpu().numpy(), ii)
    np.testing.assert_array_equal(b.cpu().numpy(), jj)


def test_kernel_rejects_too_many_lanes(cuda_device):
    rows = np.zeros((256, K.MAX_LANES + 1), np.uint32)
    lanes, tp = _tensors(rows, _upper_pairs(1), cuda_device)
    with pytest.raises(ValueError):
        K.hamming_tile_pairs(lanes, tp, tile=256, part_stride=256,
                             part_valid=256, max_dist=1)


def test_kernel_with_ids_matches_plain(cuda_device):
    """The run-id mask: kernel == plain with ids, and ids that are all
    equal give the unmasked result."""
    rng = np.random.default_rng(31)
    rows = _words(rng, 4000, 24, pool=30)
    lanes, tp = _tensors(rows, _upper_pairs(8), cuda_device)
    ids = torch.from_numpy(
        rng.integers(0, 5, 4000).astype(np.int32)).to(cuda_device)
    kw = dict(tile=512, part_stride=2048, part_valid=1900, max_dist=2)
    pa, pb = K.hamming_tile_pairs_plain(lanes, tp, ids=ids, **kw)
    free = K.hamming_tile_pairs(lanes, tp, **kw)
    assert 0 < len(pa) < len(free[0])
    for _ in range(2):
        a, b = K.hamming_tile_pairs(lanes, tp, ids=ids, **kw)
        assert torch.equal(a, pa) and torch.equal(b, pb)
    same = K.hamming_tile_pairs(lanes, tp, ids=torch.zeros_like(ids), **kw)
    assert torch.equal(same[0], free[0]) and torch.equal(same[1], free[1])


def _ring_lanes(rng, n, length, device, pool=200):
    return torch.from_numpy(
        _words(rng, n, length, pool=pool).view(np.int32)).to(device)


@pytest.mark.parametrize("upper_only", [True, False])
@pytest.mark.parametrize("length", [14, 24, 40, 72])
def test_ring_kernel_matches_plain(length, upper_only, cuda_device):
    """Ring kernel == plain on the card for w = 1, 2, 3, 5, twice, with u
    inside the column block (and, on the upper_only step, inside the row
    block too) and a block that is no multiple of any tile."""
    rng = np.random.default_rng(300 + length)
    b = 3001
    both = _ring_lanes(rng, 2 * b, length, cuda_device)  # one pool of words
    rows = both[:b].contiguous()
    cols = rows if upper_only else both[b:].contiguous()
    base = 2 * b
    kw = dict(row_base=base if upper_only else 0, col_base=base,
              u=base + 1700, max_dist=2, upper_only=upper_only)
    pa, pb = R.ring_block_pairs_plain(rows, cols, **kw)
    assert len(pa) > 0 and int(pb.max()) < kw["u"]
    launches = R.LAUNCHES
    for _ in range(2):
        a, bb = R.ring_block_pairs(rows, cols, **kw)
        assert torch.equal(a, pa) and torch.equal(bb, pb)
    assert R.LAUNCHES == launches + 2


def test_ring_kernel_max_dist_beyond_word_length(cuda_device):
    """Every valid pair matches; zero padding must stay out."""
    rows = torch.zeros((1024, 1), dtype=torch.int32, device=cuda_device)
    rows[:700] = _ring_lanes(np.random.default_rng(3), 700, 16, cuda_device)
    a, b = R.ring_block_pairs(rows, rows, row_base=0, col_base=0, u=700,
                              max_dist=20, upper_only=True)
    ii, jj = np.triu_indices(700, k=1)
    np.testing.assert_array_equal(a.cpu().numpy(), ii)
    np.testing.assert_array_equal(b.cpu().numpy(), jj)


def test_ring_kernel_capacity_rerun(cuda_device, monkeypatch):
    rng = np.random.default_rng(8)
    rows = _ring_lanes(rng, 2048, 24, cuda_device, pool=20)
    cols = _ring_lanes(rng, 2048, 24, cuda_device, pool=20)  # all pairs match
    kw = dict(row_base=2048, col_base=0, u=4096, max_dist=24,
              upper_only=False)
    pa, pb = R.ring_block_pairs_plain(rows, cols, **kw)
    assert len(pa) == 2048 * 2048
    monkeypatch.setattr(R, "CAP_START", 8)
    launches = R.LAUNCHES
    a, b = R.ring_block_pairs(rows, cols, **kw)
    assert torch.equal(a, pa) and torch.equal(b, pb)
    assert R.LAUNCHES == launches + 2  # overflow, then the exact capacity


def test_ring_kernel_rejects_too_many_lanes(cuda_device):
    t = torch.zeros((256, K.MAX_LANES + 1), dtype=torch.int32,
                    device=cuda_device)
    with pytest.raises(ValueError):
        R.ring_block_pairs(t, t, row_base=0, col_base=0, u=256, max_dist=1,
                           upper_only=True)


@pytest.mark.parametrize("cap_start", [1 << 22, 16])
def test_multi_stream_ring_matches_one_shard(cap_start, cuda_device,
                                             monkeypatch):
    """The ring over d shards (copies and kernels on separate streams)
    equals d = 1 and the dense sweep, twice in a row; with a tiny first
    buffer every shard takes the exact-capacity rerun."""
    rng = np.random.default_rng(41)
    uniq, _, _, _ = unique_words(_words(rng, 9000, 24, pool=900),
                                 want_inverse=False)
    want = N.find_neighbor_pairs(uniq, 2, word_length=24, strategy="dense",
                                 device=cuda_device)
    assert len(want[0]) > 0
    monkeypatch.setattr(R, "CAP_START", cap_start)
    for d in (1, 2, 3, 4, 8):
        mesh = P.data_mesh(d, cuda_device)
        launches = R.LAUNCHES
        for _ in range(2):
            got = P.sharded_neighbor_pairs_ring(uniq, 2, word_length=24,
                                                mesh=mesh)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        assert R.LAUNCHES > launches


@pytest.mark.parametrize("strategy", ["ring", "sharded", "sharded_bucketed"])
def test_mesh_engines_on_cuda_match_cpu(strategy, cuda_device):
    rng = np.random.default_rng(78)
    uniq, _, _, _ = unique_words(_words(rng, 6000, 24, pool=700),
                                 want_inverse=False)
    got = N.find_neighbor_pairs(uniq, 2, word_length=24, strategy=strategy,
                                device=cuda_device,
                                mesh=P.data_mesh(3, cuda_device))
    want = N.find_neighbor_pairs(uniq, 2, word_length=24, strategy="dense",
                                 device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _mesh_table():
    rng = np.random.default_rng(81)
    uniq = unique_words(_words(rng, 20000, 24, pool=2000),
                        want_inverse=False)[0]
    return uniq, N.find_neighbor_pairs(uniq, 1, word_length=24,
                                       strategy="runs", device="cpu")


@pytest.mark.parametrize("d", [1, 3, 4, 8])
def test_concurrent_mesh_search_equals_runs(d, cuda_device):
    """The bucketed mesh search with every shard enqueued at once, d
    shards over the cards there are, equals the host runs engine."""
    uniq, want = _mesh_table()
    assert len(want[0]) > 0
    for _ in range(2):
        got = P.sharded_neighbor_pairs_bucketed(
            uniq, 1, word_length=24, mesh=P.data_mesh(d, cuda_device))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("cap_start", [1 << 23, 8], ids=["fits", "rerun"])
def test_concurrent_mesh_search_waits(cap_start, cuda_device, monkeypatch):
    """Under set_sync_debug_mode("error") the mesh search waits only where
    it reads: the counters once a shard, once more a shard rerun with the
    exact capacity, and each shard's keys in one copy; every launch of
    every shard comes before the first read."""
    from humid_tpu_torch import _device as D
    from humid_tpu_torch.parallel import neighbors as PN

    uniq, want = _mesh_table()
    prep = PN.bucketed_shard_inputs(uniq, 1, 24, 4)
    shards = sum(1 for n in prep["urows"] if n)
    log = []
    read_back, to_host, launch = K._read_back, D.to_host, K._launch

    def waiting(fn, tag):
        def wrapped(*args):
            log.append(tag)
            torch.cuda.set_sync_debug_mode("default")
            try:
                return fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return wrapped

    def launching(*args, **kw):
        log.append("launch")
        return launch(*args, **kw)

    monkeypatch.setattr(K, "_read_back", waiting(read_back, "counters"))
    monkeypatch.setattr(D, "to_host", waiting(to_host, "keys"))
    monkeypatch.setattr(K, "_launch", launching)
    monkeypatch.setattr(K, "CAP_START", cap_start)
    mesh = P.data_mesh(4, cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = P.sharded_neighbor_pairs_bucketed(uniq, 1, word_length=24,
                                                mesh=mesh)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    reruns = shards if cap_start == 8 else 0
    assert log.count("counters") == shards + reruns
    assert log.count("keys") == shards
    first_read = log.index("counters")
    assert set(log[:first_read]) == {"launch"}
    assert log.count("launch") == first_read * (2 if reruns else 1)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("strategy", ["dense", "bucketed"])
def test_engines_on_cuda_match_cpu(strategy, cuda_device):
    rng = np.random.default_rng(77)
    uniq, _, _, _ = unique_words(_words(rng, 6000, 24, pool=700),
                                 want_inverse=False)
    got = N.find_neighbor_pairs(uniq, 2, word_length=24, strategy=strategy,
                                device=cuda_device)
    want = N.find_neighbor_pairs(uniq, 2, word_length=24, strategy=strategy,
                                 device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _edited_words(rng, n, length, m, pool):
    """Pool words with substitutions and shifts (indels at both ends)."""
    base = rng.integers(0, 4, (pool, length), dtype=np.uint8)
    codes = base[rng.integers(0, pool, n)]
    sub = np.flatnonzero(rng.random(n) < 0.4)
    codes[sub, rng.integers(0, length, len(sub))] = rng.integers(
        0, 4, len(sub), dtype=np.uint8)
    for d in range(1, m + 1):
        rows = np.flatnonzero(rng.random(n) < 0.2)
        codes[rows, d:] = codes[rows, :length - d]
        codes[rows, :d] = rng.integers(0, 4, (len(rows), d), dtype=np.uint8)
    return codes


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("length", [18, 24, 33])
def test_edit_programs_on_cuda_match_cpu(length, m, cuda_device):
    """The DP on the card against the same functions on the CPU: the
    block form (plain and batched), the pairwise form and edit_block."""
    rng = np.random.default_rng(100 * m + length)
    codes = _edited_words(rng, 900, length, m, pool=40)
    a = torch.from_numpy(codes[:400].astype(np.int32))
    b = torch.from_numpy(codes[400:].astype(np.int32))
    want = E._banded_levenshtein(a, b, m, length)
    got = E._banded_levenshtein(a.to(cuda_device), b.to(cuda_device), m,
                                length)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    assert int(want.min()) == 0 and int(want.max()) == m + 1
    a3, b3 = a.view(2, 200, length), b[:400].view(2, 200, length)
    assert torch.equal(
        E._banded_levenshtein(a3.to(cuda_device), b3.to(cuda_device), m,
                              length).cpu(),
        E._banded_levenshtein(a3, b3, m, length))
    assert torch.equal(
        E._banded_levenshtein_pairs(a.to(cuda_device),
                                    b[:400].to(cuda_device), m, length).cpu(),
        E._banded_levenshtein_pairs(a, b[:400], m, length))
    lanes = torch.from_numpy(W.pack_words(codes).view(np.int32))
    on_card = lanes.to(cuda_device)
    assert torch.equal(E._unpack(on_card, length).cpu(),
                       E._unpack(lanes, length))
    for g, w_ in zip(E.edit_block(on_card[:500], on_card[300:], 0, 300, m,
                                  1 << 14, length),
                     E.edit_block(lanes[:500], lanes[300:], 0, 300, m,
                                  1 << 14, length)):
        assert torch.equal(g.cpu(), w_)


def test_edit_pairs_verify_on_cuda_waits_once(cuda_device, monkeypatch):
    """Several batches, and no host synchronisation between the table's
    upload and the one wait after the last batch: every synchronising
    call in between raises under the sync debug mode."""
    rng = np.random.default_rng(8)
    packed = W.pack_words(_edited_words(rng, 5000, 24, 2, pool=300))
    a = rng.integers(0, 5000, 40_000).astype(np.int64)
    b = rng.integers(0, 5000, 40_000).astype(np.int64)
    want = E.edit_pairs_verify(packed, a, b, 2, 24, device="cpu")
    assert 0 < len(want[0]) < len(a)
    E.edit_pairs_verify(packed, a[:100], b[:100], 2, 24, device=cuda_device)
    waits = []
    upload, wait = E.lanes_tensor, E._wait

    def armed_upload(*args):  # the table's upload is a blocking copy
        lanes = upload(*args)
        torch.cuda.set_sync_debug_mode("error")
        return lanes

    def counted_wait(dev):
        waits.append(1)
        torch.cuda.set_sync_debug_mode("default")
        wait(dev)

    monkeypatch.setattr(E, "lanes_tensor", armed_upload)
    monkeypatch.setattr(E, "_wait", counted_wait)
    try:
        got = E.edit_pairs_verify(packed, a, b, 2, 24, batch=1 << 13,
                                  device=cuda_device)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(waits) == 1
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("strategy", ["dense", "runs", "sharded"])
def test_edit_engines_on_cuda_match_cpu(strategy, cuda_device):
    rng = np.random.default_rng(79)
    uniq, _, _, _ = unique_words(
        W.pack_words(_edited_words(rng, 6000, 24, 2, pool=700)),
        want_inverse=False)
    assert len(uniq) > 2048
    want = N.find_neighbor_pairs(uniq, 2, metric="edit", word_length=24,
                                 strategy="dense", device="cpu")
    assert len(want[0]) > 0
    got = N.find_neighbor_pairs(uniq, 2, metric="edit", word_length=24,
                                strategy=strategy, device=cuda_device,
                                mesh=P.data_mesh(3, cuda_device))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_edit_ring_on_cuda_matches_cpu(d, cuda_device):
    """The dense edit ring on the ring kernel's streams and events: d
    shards spread over the cards there are."""
    rng = np.random.default_rng(80)
    uniq, _, _, _ = unique_words(
        W.pack_words(_edited_words(rng, 3000, 33, 2, pool=300)),
        want_inverse=False)
    want = N.find_neighbor_pairs(uniq, 2, metric="edit", word_length=33,
                                 strategy="dense", device="cpu")
    assert len(want[0]) > 0
    for _ in range(2):
        got = P.sharded_neighbor_pairs(uniq, 2, metric="edit", word_length=33,
                                       mesh=P.data_mesh(d, cuda_device))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("run_cap", [2048, 6], ids=["runs", "big_runs"])
@pytest.mark.parametrize("strategy", ["runs", "runs_device"])
def test_runs_engines_on_cuda_match_cpu(strategy, run_cap, cuda_device):
    """Both pigeonhole runs engines on the card == the dense sweep on the
    CPU; with a tiny run_cap the big runs go through the tile sweep with
    its run-id mask (at least one kernel launch)."""
    rng = np.random.default_rng(81)
    uniq, _, _, _ = unique_words(_words(rng, 6000, 24, pool=700),
                                 want_inverse=False)
    want = N.find_neighbor_pairs(uniq, 2, word_length=24, strategy="dense",
                                 device="cpu")
    fn = (N.find_neighbor_pairs_runs if strategy == "runs"
          else RD.runs_device_pairs)
    launches = K.LAUNCHES
    info = {}
    got = fn(uniq, 2, word_length=24, run_cap=run_cap, device=cuda_device,
             info=info)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert info["dense_fallbacks"] == 0
    assert (K.LAUNCHES > launches) == (run_cap == 6)


@pytest.mark.parametrize("w", [1, 2, 3])
def test_unique_words_device_on_cuda_matches_host(w, cuda_device):
    """Device unique counting on the card == the host radix sort, with
    words whose bit 31 is set and all-T words."""
    rng = np.random.default_rng(90 + w)
    pool = rng.integers(0, 2 ** 32, (5000, w), dtype=np.uint64).astype(
        np.uint32)
    pool[:3] = 0xFFFFFFFF
    pool[3:40, 0] |= 0x80000000
    packed = pool[rng.integers(0, len(pool), 80_000)]
    want = unique_words(packed, want_inverse=True)
    got = U.unique_words_device(packed, True, device=cuda_device)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)


def _reads(rng, n, wl, dup=6, mut_p=0.3):
    pool = rng.integers(0, 4, (max(n // dup, 1), wl), dtype=np.uint8)
    codes = pool[rng.integers(0, len(pool), n)]
    mut = np.flatnonzero(rng.random(n) < mut_p)
    codes[mut, rng.integers(0, wl, len(mut))] = rng.integers(
        0, 4, len(mut), dtype=np.uint8)
    return W.pack_words(codes)


def _fused(packed, filtered, device, *, chunk_rows=4096, unique=True, **kw):
    """A FusedPipeline fed in batches of 3,000 reads (after unique())."""
    feeder = F.DeviceFeeder(packed.shape[1], len(packed) // 5, device=device,
                            chunk_rows=chunk_rows)
    keep = ~filtered
    for lo in range(0, len(packed), 3000):
        feeder.push(packed[lo:lo + 3000][keep[lo:lo + 3000]])
    fp = F.FusedPipeline(feeder, len(packed), filtered, **kw)
    if unique:
        fp.unique()
    return fp


@pytest.mark.parametrize("wl,m,d_cap,run_cap", [
    (24, 1, 8, 2048), (24, 2, 2, 64), (33, 2, 1, 12), (16, 1, 8, 4)],
    ids=["w2_m1", "w2_m2_mid", "w3_big", "w1_small_cap"])
def test_fused_on_cuda_matches_cpu(wl, m, d_cap, run_cap, cuda_device):
    """The fused route on the card (feeder growth, filtered reads, the
    inverse, mid runs, big runs through the tile sweep, the giant-runs
    fallback, program D's labels) == the same on the CPU, and its labels ==
    connected components of its pairs."""
    rng = np.random.default_rng(wl + m)
    packed = _reads(rng, 40_000, wl, dup=60 if run_cap < 100 else 6)
    filtered = rng.random(len(packed)) < 0.1
    kw = dict(word_length=wl, max_dist=m, want_inverse=True,
              want_labels=True, d_cap=d_cap, run_cap=run_cap)
    card = _fused(packed, filtered, cuda_device, **kw)
    cpu = _fused(packed, filtered, "cpu", **kw)
    assert card.k == cpu.k
    for g, x in zip(card.tables(), cpu.tables()):
        np.testing.assert_array_equal(g, x)
    info_card, info_cpu = {}, {}
    got = card.neighbors(info=info_card)
    want = cpu.neighbors(info=info_cpu)
    assert info_card == info_cpu
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(card.table(), cpu.table())
    if card.has_matches:
        labels = card.device_labels()
        np.testing.assert_array_equal(labels, cpu.device_labels())
        np.testing.assert_array_equal(labels, connected_components_device(
            got[0], got[1], card.k, device=cuda_device))


def test_fused_waits_only_at_its_read_backs(cuda_device, monkeypatch):
    """unique() waits once (k), neighbors() at its bundled read-backs (run
    structure, bitmaps, sparse gathers), tables() once: every other
    synchronising call raises under the sync debug mode."""
    rng = np.random.default_rng(7)
    packed = _reads(rng, 60_000, 24)
    filtered = np.zeros(len(packed), bool)
    kw = dict(word_length=24, max_dist=1, want_inverse=True)
    want = _fused(packed, filtered, "cpu", **kw).neighbors()
    _fused(packed, filtered, cuda_device, **kw).neighbors()  # warm up
    fp = _fused(packed, filtered, cuda_device, unique=False, **kw)
    waits = []
    real = F.to_host

    def counted(*tensors):
        waits.append(1)
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real(*tensors)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(F, "to_host", counted)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fp.unique()
        n_unique = len(waits)
        info = {}
        pairs = fp.neighbors(info=info)
        n_neighbors = len(waits) - n_unique
        fp.tables()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert n_unique == 1
    assert info["decode"] == "sparse" and 2 <= n_neighbors <= 4
    assert len(waits) == n_unique + n_neighbors + 1
    np.testing.assert_array_equal(pairs[0], want[0])
    np.testing.assert_array_equal(pairs[1], want[1])


def test_feeder_reuses_pinned_buffers_safely(cuda_device):
    """Hundreds of chunks through the two pinned staging buffers, the
    buffer doubling four times on the way: every row lands where it
    belongs (a buffer refilled before its copy landed would corrupt
    rows), the tail stays all ones."""
    rng = np.random.default_rng(3)
    n = 300_000
    packed = rng.integers(0, 2 ** 32, (n, 3), dtype=np.uint64).astype(
        np.uint32)
    feeder = F.DeviceFeeder(3, n // 16, device=cuda_device, chunk_rows=1024)
    lo = 0
    while lo < n:
        hi = min(n, lo + int(rng.integers(1, 5000)))
        feeder.push(packed[lo:hi])
        lo = hi
    buf = feeder.finish().cpu().numpy().view(np.uint32)
    assert feeder.n == n and feeder.cap >= n
    np.testing.assert_array_equal(buf[:n], packed)
    assert np.all(buf[n:] == 0xFFFFFFFF)


@pytest.fixture(scope="module")
def humid_ref(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None or not os.path.exists("/usr/include/zlib.h"):
        pytest.skip("g++ or zlib not available")
    exe = str(tmp_path_factory.mktemp("humid_ref") / "humid_ref")
    subprocess.run([gxx, "-O2", "-std=c++17", "-o", exe,
                    os.path.join(REPO, "baseline", "humid_ref.cpp"), "-lz"],
                   check=True)
    return exe


def _read(path):
    p = str(path)
    opener = gzip.open if p.endswith(".gz") else open
    with opener(p, "rb") as f:
        return f.read()


@pytest.mark.parametrize("n_files,umi,extra,gen_kw", [
    (1, "none", [], {}), (2, "underscore", ["-m", "2"], {}),
    (1, "none", ["-n", "80"], {"read_len": 90}),
    (2, "underscore", ["-x", "-m", "3"], {"ragged": True}),
    (1, "none", ["-e"], {}), (2, "underscore", ["-e", "-m", "2"], {}),
    (1, "none", ["-e", "-x"], {"ragged": True})],
    ids=["single", "paired_m2", "n80", "max_m3_ragged", "edit", "edit_m2",
         "edit_max_ragged"])
def test_cli_on_cuda_matches_humid_ref(n_files, umi, extra, gen_kw,
                                       cuda_device, humid_ref, tmp_path,
                                       monkeypatch):
    """The CLI on the card by its default route (calibration off: the
    device engines, the fused route for Hamming) and, for Hamming, by the
    bucketed tile sweep (at least one kernel launch)."""
    from humid_tpu_torch.cli import main

    gen_dataset(np.random.default_rng(n_files + len(extra)), str(tmp_path),
                n_reads=3000, n_files=n_files, umi_style=umi, **gen_kw)
    files = [str(tmp_path / f"file{i}.fastq") for i in range(n_files)]
    (tmp_path / "ref").mkdir()
    subprocess.run([humid_ref, "-d", str(tmp_path / "ref"), "-s", "-a",
                    *extra, *files], check=True, capture_output=True)
    monkeypatch.setenv("HUMID_TPU_TORCH_DEVICE", "cuda")
    monkeypatch.setenv("HUMID_TPU_TORCH_CALIBRATION", "off")
    routes = [("port", None)] + ([] if "-e" in extra
                                 else [("bucketed", "bucketed")])
    for out, strategy in routes:
        if strategy:
            monkeypatch.setenv("HUMID_TPU_TORCH_STRATEGY", strategy)
        launches = K.LAUNCHES
        assert main(["-d", str(tmp_path / out), "-s", "-a", "-l",
                     os.devnull, *extra, *files]) == 0
        assert not strategy or K.LAUNCHES > launches
        names = sorted(os.listdir(tmp_path / "ref"))
        assert names == sorted(os.listdir(tmp_path / out))
        for name in names:
            assert _read(tmp_path / "ref" / name) == \
                _read(tmp_path / out / name), name


# -- the multi-process layer and the mesh labels on the card -------------

@pytest.mark.parametrize("n_parts", [2, 3])
def test_cluster_sharded_local_on_cuda_matches_cpu(n_parts, cuda_device):
    """The extension-less local cluster step with its components on the
    card gives each process the CPU's arrays."""
    from humid_tpu_torch.ops import pairs_to_csr
    from humid_tpu_torch.parallel.cluster import _local_subgraph

    rng = np.random.default_rng(n_parts)
    u = 50_000
    a = rng.integers(0, u, 40_000)
    b = np.minimum(u - 1, a + rng.integers(1, 30, 40_000))
    pa, pb = N._dedupe_pairs(a, b)
    keep = pa != pb
    pa, pb = pa[keep], pb[keep]
    counts = rng.integers(1, 50, u).astype(np.int64)
    indptr, indices = pairs_to_csr(pa, pb, u)
    for part in range(n_parts):
        kw = dict(maximum=False, shard=(part, n_parts))
        got = _local_subgraph(counts, indptr, indices, pa, pb,
                              device=cuda_device, **kw)
        want = _local_subgraph(counts, indptr, indices, pa, pb,
                               device="cpu", **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("engine", ["bucketed", "dense"])
def test_tile_pair_stripes_on_cuda_match_cpu(engine, cuda_device):
    """Each part's stripe of tile pairs through K1 on the card (the
    bucketed engine with its run-id mask) equals the CPU's plain version,
    and the parts tile the whole pair list."""
    uniq = unique_words(_words(np.random.default_rng(5), 20_000, 24,
                               pool=2_000), want_inverse=False)[0]
    kw = dict(word_length=24, strategy=engine, tile=512)
    full = N.find_neighbor_pairs(uniq, 1, device=cuda_device, **kw)
    parts = []
    for p in range(3):
        launches = K.LAUNCHES
        got = N.find_neighbor_pairs(uniq, 1, device=cuda_device,
                                    shard=(p, 3), **kw)
        assert K.LAUNCHES > launches
        want = N.find_neighbor_pairs(uniq, 1, device="cpu", shard=(p, 3),
                                     **kw)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g, w_)
        parts.append(got)
    union = N._dedupe_pairs(np.concatenate([x[0] for x in parts]),
                            np.concatenate([x[1] for x in parts]))
    for g, w_ in zip(union, full):
        np.testing.assert_array_equal(g, w_)


@pytest.mark.parametrize("engine", ["runs", "runs_device"])
def test_owned_big_runs_on_cuda_match_cpu(engine, cuda_device):
    """run_cap = 12: the owned big runs go through K1 with the run-id mask
    on the card; each part equals the CPU's."""
    base = np.random.default_rng(7).integers(0, 4, (40, 24), dtype=np.uint8)
    rng = np.random.default_rng(8)
    codes = base[rng.integers(0, 40, 1500)].copy()
    flip = np.flatnonzero(rng.random(1500) < 0.8)
    codes[flip, rng.integers(0, 24, len(flip))] = rng.integers(
        0, 4, len(flip), dtype=np.uint8)
    uniq = unique_words(W.pack_words(codes), want_inverse=False)[0]
    fn = (N.find_neighbor_pairs_runs if engine == "runs"
          else RD.runs_device_pairs)
    for p in range(2):
        launches = K.LAUNCHES
        got = fn(uniq, 1, word_length=24, run_cap=12, tile=256,
                 device=cuda_device, shard=(p, 2))
        assert K.LAUNCHES > launches
        want = fn(uniq, 1, word_length=24, run_cap=12, tile=256,
                  device="cpu", shard=(p, 2))
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g, w_)


@pytest.mark.parametrize("node_sharded", [False, True])
@pytest.mark.parametrize("d", [1, 4])
def test_distributed_components_on_cuda_match_cpu(d, node_sharded,
                                                  cuda_device):
    rng = np.random.default_rng(d)
    n = 80_000
    a = rng.integers(0, n, 50_000)
    b = np.minimum(n - 1, a + rng.integers(1, 20_000, 50_000))
    got = P.distributed_components(a, b, n, mesh=P.data_mesh(d, cuda_device),
                                   node_sharded=node_sharded)
    want = P.distributed_components(a, b, n, mesh=P.data_mesh(d, "cpu"),
                                    node_sharded=node_sharded)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, connected_components_device(
        a, b, n, device="cpu"))


def test_dedup_step_on_cuda_matches_cpu(cuda_device):
    uniq = unique_words(_words(np.random.default_rng(9), 20_000, 24,
                               pool=3_000), want_inverse=False)[0]
    launches = R.LAUNCHES
    got, counts = P.dedup_step(uniq, 1, mesh=P.data_mesh(4, cuda_device))
    assert R.LAUNCHES > launches
    want, want_counts = P.dedup_step(uniq, 1, mesh=P.data_mesh(4, "cpu"))
    np.testing.assert_array_equal(got, want)
    assert counts.sum() == want_counts.sum()


def test_cli_two_processes_on_cuda_match_single_process(cuda_device,
                                                        tmp_path):
    """Two CLI processes in a gloo group on the one card (each a CUDA
    context of its own) write the single-process CLI's bytes."""
    import socket

    gen_dataset(np.random.default_rng(3), str(tmp_path), n_reads=4000,
                n_files=2, umi_style="underscore")
    files = [str(tmp_path / f"file{i}.fastq") for i in range(2)]
    env = dict(os.environ, HUMID_TPU_TORCH_DEVICE="cuda",
               HUMID_TPU_TORCH_CALIBRATION="off")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "humid_tpu_torch", "-s", "-a", "-l",
           os.devnull]
    procs = [subprocess.Popen(cmd + ["-d", str(tmp_path / "one"), *files],
                              env=env, stderr=subprocess.PIPE)]
    procs += [subprocess.Popen(
        cmd + ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
               "--process-id", str(p), "-d", str(tmp_path / "two"), *files],
        env=env, stderr=subprocess.PIPE) for p in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err.decode()[-2000:]
    names = sorted(os.listdir(tmp_path / "one"))
    assert names == sorted(os.listdir(tmp_path / "two"))
    for name in names:
        assert _read(tmp_path / "one" / name) == \
            _read(tmp_path / "two" / name), name


def _pair_graph(rng, u, e_factor, count_hi=50):
    a = rng.integers(0, u, int(u * e_factor))
    b = rng.integers(0, u, int(u * e_factor))
    keep = a != b
    key = np.unique(np.minimum(a, b)[keep] * u + np.maximum(a, b)[keep])
    return (rng.integers(1, count_hi, u).astype(np.int64), key // u,
            key % u)


@pytest.mark.parametrize("seed,u,e_factor,count_hi", [
    (1, 300, 2.0, 50), (2, 2000, 1.0, 200), (3, 400, 3.0, 5),
    (4, 50000, 0.3, 1000)])
def test_directional_device_on_cuda_matches_cpu(seed, u, e_factor, count_hi,
                                                cuda_device):
    from humid_tpu_torch.cluster.directional_device import (
        cluster_directional_device)

    counts, pa, pb = _pair_graph(np.random.default_rng(seed), u, e_factor,
                                 count_hi)
    got = cluster_directional_device(counts, pa, pb, device=cuda_device)
    want = cluster_directional_device(counts, pa, pb, device="cpu")
    for field in ("labels", "max_leaf", "max_count", "size"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


def test_directional_rounds_wait_once_a_round(cuda_device, monkeypatch):
    """Under set_sync_debug_mode("error") the round loop's only host wait
    is its "anything unassigned?" read: rounds + 1 of them."""
    from humid_tpu_torch.cluster import directional_device as D
    from humid_tpu_torch.cluster.labelprop import components_tensor

    counts, pa, pb = _pair_graph(np.random.default_rng(5), 3000, 1.0)
    comp = components_tensor(pa, pb, len(counts), cuda_device)
    args = [torch.from_numpy(x).to(cuda_device) for x in (counts, pa, pb)]
    want = D._directional_rounds(*(t.cpu() for t in (args[0], comp,
                                                     args[1], args[2])))
    torch.cuda.synchronize()
    waits = []
    real = D._any_unassigned

    def counted(cluster_seed):
        waits.append(1)
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real(cluster_seed)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(D, "_any_unassigned", counted)
    torch.cuda.set_sync_debug_mode("error")
    try:
        seed, max_leaf, rounds = D._directional_rounds(args[0], comp,
                                                       args[1], args[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert rounds == want[2] and len(waits) == rounds + 1
    assert torch.equal(seed.cpu(), want[0])
    assert torch.equal(max_leaf.cpu(), want[1])


def test_device_directional_run_on_cuda_matches_default(cuda_device,
                                                       tmp_path,
                                                       monkeypatch):
    import humid_tpu_torch

    monkeypatch.setenv("HUMID_TPU_TORCH_CALIBRATION", "off")
    monkeypatch.delenv("HUMID_TPU_TORCH_CLUSTER", raising=False)
    gen_dataset(np.random.default_rng(64), str(tmp_path), n_reads=3000,
                n_files=2, umi_style="underscore", ragged=True)
    files = [str(tmp_path / f"file{i}.fastq") for i in range(2)]
    kw = dict(log_name=os.devnull, run_stats=True, write_annotated=True,
              device=cuda_device)
    humid_tpu_torch.run(files, dir_name=str(tmp_path / "default"), **kw)
    monkeypatch.setenv("HUMID_TPU_TORCH_CLUSTER", "device")
    res = humid_tpu_torch.run(files, dir_name=str(tmp_path / "device"),
                              **kw)
    assert res.extra["engine"]["directional"] == "device"
    for name in sorted(os.listdir(tmp_path / "default")):
        assert ((tmp_path / "default" / name).read_bytes()
                == (tmp_path / "device" / name).read_bytes()), name
