"""The port's Hamming tile sweep (humid_tpu_torch.ops.cuda_hamming)
against the JAX package's Pallas kernel and XOR block oracle.

Inputs are made with numpy from fixed seeds and fed to both packages.
All of this is integer work, so every comparison is exact equality.  The
Pallas kernel runs in interpret mode, as the JAX package's own tests run
it on the CPU, at <= 1024 rows and tile 256.  The CUDA kernel itself is
compared with the plain version on a card in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from humid_tpu.ops import neighbors as JN
from humid_tpu.ops.hamming import hamming_block_xor
from humid_tpu_torch import words as W
from humid_tpu_torch.ops import cuda_hamming as K
from humid_tpu_torch.ops.hamming import (lanes_u32, mismatch_counts,
                                         mismatch_counts_planes, planes)


def _words(rng, n, length, pool=30):
    """[n, w] uint32 packed words: a small pool with substitutions, so
    many pairs fall within small distances."""
    base = rng.integers(0, 4, (pool, length), dtype=np.uint8)
    codes = base[rng.integers(0, pool, n)]
    mut = rng.random(n) < 0.6
    codes[np.flatnonzero(mut), rng.integers(0, length, int(mut.sum()))] = (
        rng.integers(0, 4, int(mut.sum()), dtype=np.uint8))
    return W.pack_words(codes)


def _tensors(rows, pairs, on=None):
    tp = np.ones((len(pairs), 3), np.int32)
    tp[:, :2] = pairs
    if on is not None:
        tp[:, 2] = on
    return torch.from_numpy(rows.view(np.int32)), torch.from_numpy(tp)


# Two partitions of 512 rows, 400 of them real, in tiles of 256: the
# stacked layout of the bucketed engine.
_PAIRS = np.array([(0, 0), (0, 1), (1, 1), (2, 2), (2, 3), (3, 3)],
                  np.int32)


@pytest.mark.parametrize("max_dist", [1, 2])
@pytest.mark.parametrize("length", [14, 24, 40])  # w = 1, 2, 3
def test_plain_matches_pallas(length, max_dist):
    rng = np.random.default_rng(100 + length + max_dist)
    rows = _words(rng, 1024, length)
    run = JN._pallas_chunked_run(rows, _PAIRS, 512, 400, max_dist,
                                 tile=256, interpret=True)
    ja, jb = JN._extract_with_retry(run, 1024, 256, 16, 1 << 20)
    lanes, tp = _tensors(rows, _PAIRS)
    a, b = K.hamming_tile_pairs(lanes, tp, tile=256, part_stride=512,
                                part_valid=400, max_dist=max_dist)
    assert len(ja) > 0
    np.testing.assert_array_equal(a.numpy(), ja)
    np.testing.assert_array_equal(b.numpy(), jb)


@pytest.mark.parametrize("length", [14, 24, 40])
def test_plain_matches_block_xor(length):
    """Every upper-triangular tile pair of an unpadded table == the XOR
    block oracle over the whole table."""
    rng = np.random.default_rng(7 + length)
    n = 700  # not a multiple of the tile: a ragged last tile
    rows = _words(rng, n, length)
    r_idx, c_idx, count = hamming_block_xor(
        jnp.asarray(rows), jnp.asarray(rows), 0, 0, 2, cap=1 << 16)
    count = int(count)
    ref = np.stack([np.asarray(r_idx)[:count], np.asarray(c_idx)[:count]])
    ref = ref[:, np.lexsort((ref[1], ref[0]))]
    ii, jj = np.triu_indices(3)
    lanes, tp = _tensors(rows, np.stack([ii, jj], axis=1))
    a, b = K.hamming_tile_pairs(lanes, tp, tile=256, part_stride=768,
                                part_valid=n, max_dist=2)
    np.testing.assert_array_equal(np.stack([a.numpy(), b.numpy()]), ref)


def test_disabled_pairs_and_padding_emit_nothing():
    """on = 0 rows emit nothing, and padding rows (all-'A' zero words, at
    distance 0 from each other) never match."""
    rng = np.random.default_rng(3)
    rows = _words(rng, 1024, 24)
    rows[400:512] = 0
    rows[912:] = 0
    on = np.array([1, 0, 1, 0, 1, 1], np.int32)
    lanes, tp = _tensors(rows, _PAIRS, on)
    a, b = K.hamming_tile_pairs(lanes, tp, tile=256, part_stride=512,
                                part_valid=400, max_dist=3)
    lanes, tp = _tensors(rows, _PAIRS[on == 1])
    ea, eb = K.hamming_tile_pairs(lanes, tp, tile=256, part_stride=512,
                                  part_valid=400, max_dist=3)
    np.testing.assert_array_equal(a.numpy(), ea.numpy())
    np.testing.assert_array_equal(b.numpy(), eb.numpy())
    assert not ((a.numpy() % 512) >= 400).any()
    assert not ((b.numpy() % 512) >= 400).any()
    assert (a < b).all()


def test_max_dist_beyond_word_length_keeps_padding_out():
    """With max_dist >= 16*w every real pair matches; the explicit mask
    still keeps padding out (the TPU kernel needs max_dist < 16*w)."""
    rng = np.random.default_rng(4)
    rows = np.zeros((512, 1), np.uint32)
    rows[:300] = _words(rng, 300, 16)
    lanes, tp = _tensors(rows, np.array([(0, 0), (0, 1), (1, 1)]))
    a, b = K.hamming_tile_pairs(lanes, tp, tile=256, part_stride=512,
                                part_valid=300, max_dist=16)
    ii, jj = np.triu_indices(300, k=1)
    np.testing.assert_array_equal(a.numpy(), ii)
    np.testing.assert_array_equal(b.numpy(), jj)


def test_capacity_retry_and_split(monkeypatch):
    """A pair buffer that overflows is relaunched once with the exact
    count, and a chunk whose count exceeds MAX_CAP is split; the result
    is unchanged."""
    rng = np.random.default_rng(5)
    rows = _words(rng, 1024, 24)
    lanes, tp = _tensors(rows, _PAIRS)
    kw = dict(tile=256, part_stride=512, part_valid=400, max_dist=2)
    ea, eb = K.hamming_tile_pairs(lanes, tp, **kw)

    caps = []
    real_sweep = K._sweep

    def recording_sweep(lanes, pairs, cap, **kw):
        caps.append((len(pairs), cap))
        return real_sweep(lanes, pairs, cap, **kw)

    monkeypatch.setattr(K, "_sweep", recording_sweep)
    monkeypatch.setattr(K, "CAP_START", 4)
    a, b = K.hamming_tile_pairs(lanes, tp, **kw)
    np.testing.assert_array_equal(a.numpy(), ea.numpy())
    np.testing.assert_array_equal(b.numpy(), eb.numpy())
    assert caps[0] == (6, 4) and caps[1][1] == len(ea)

    caps.clear()
    monkeypatch.setattr(K, "MAX_CAP", 4)
    a, b = K.hamming_tile_pairs(lanes, tp, **kw)
    np.testing.assert_array_equal(a.numpy(), ea.numpy())
    np.testing.assert_array_equal(b.numpy(), eb.numpy())
    assert min(n for n, _ in caps) == 1  # split down to single tile pairs


def test_chunking(monkeypatch):
    rng = np.random.default_rng(6)
    rows = _words(rng, 1024, 24)
    lanes, tp = _tensors(rows, _PAIRS)
    kw = dict(tile=256, part_stride=512, part_valid=400, max_dist=1)
    ea, eb = K.hamming_tile_pairs(lanes, tp, **kw)
    monkeypatch.setattr(K, "CHUNK_PAIRS", 4)
    a, b = K.hamming_tile_pairs(lanes, tp, **kw)
    np.testing.assert_array_equal(a.numpy(), ea.numpy())
    np.testing.assert_array_equal(b.numpy(), eb.numpy())


@pytest.mark.parametrize("bad", ["lower", "negative", "dtype", "shape",
                                 "strided"])
def test_rejects_bad_inputs(bad):
    rows = np.zeros((512, 2), np.uint32)
    lanes, tp = _tensors(rows, np.array([(0, 0), (0, 1)]))
    if bad == "lower":
        tp[1, :2] = torch.tensor([1, 0])
    elif bad == "negative":
        tp[0, 0] = -1
    elif bad == "dtype":
        lanes = lanes.to(torch.int64)
    elif bad == "shape":
        tp = tp[:, :2].contiguous()
    elif bad == "strided":
        lanes = torch.zeros((512, 4), dtype=torch.int32)[:, ::2]
    with pytest.raises(ValueError):
        K.hamming_tile_pairs(lanes, tp, tile=256, part_stride=512,
                             part_valid=512, max_dist=1)


def test_mismatch_counts_match_numpy():
    """The SWAR popcount statement of the metric == numpy's popcount,
    including lanes with bit 31 set (negative as int32)."""
    rng = np.random.default_rng(8)
    a = rng.integers(0, 2**32, (50, 3), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (40, 3), dtype=np.uint64).astype(np.uint32)
    z = a[:, None, :] ^ b[None, :, :]
    ref = np.bitwise_count((z | (z >> np.uint32(1)))
                           & np.uint32(0x55555555)).sum(axis=2)
    got = mismatch_counts(lanes_u32(torch.from_numpy(a.view(np.int32))),
                          lanes_u32(torch.from_numpy(b.view(np.int32))))
    np.testing.assert_array_equal(got.numpy(), ref)


def _plane_inputs(rng, w):
    """[60, w] uint32 words that stress the plane transform: random lanes
    (bit 31 set in many), all-T words, zero padding rows, and copies of
    one word that differ from it only in the last base of the last lane
    (for odd w the lane whose partner in the plane pair is empty)."""
    x = rng.integers(0, 2**32, (60, w), dtype=np.uint64).astype(np.uint32)
    x[10:14] = 0xFFFFFFFF
    x[14:20] = 0
    for k, code in enumerate((1, 2, 3)):
        x[21 + k] = x[20]
        x[21 + k, w - 1] ^= np.uint32(code)
    return x


@pytest.mark.parametrize("w", range(1, 17))
def test_planes_match_mismatch_counts(w):
    """The bit-plane statement of the metric (one popcount per 32 bases,
    what the CUDA kernels compute) == the lane statement, for every lane
    count the kernels are built for; int32 bit views give the same planes
    as the unsigned values."""
    x = _plane_inputs(np.random.default_rng(900 + w), w)
    signed = torch.from_numpy(x.view(np.int32))
    vals = lanes_u32(signed)
    want = mismatch_counts(vals, vals)
    assert torch.equal(mismatch_counts_planes(vals, vals), want)
    assert torch.equal(mismatch_counts_planes(signed, signed), want)
    assert want[20, 21:24].tolist() == [1, 1, 1] and int(want[10, 11]) == 0
    pl = planes(signed)
    assert pl.shape == (60, 2 * ((w + 1) // 2))
    assert int(pl.min()) >= 0 and int(pl.max()) < 2**32
    assert not pl[14:20].any()
    if w % 2:  # the empty partner lane leaves the odd bit positions clear
        assert not (pl[:, -2:] & 0xAAAAAAAA).any()
    # Every base owns one bit: the planes hold exactly the lanes' bits.
    bits = np.bitwise_count(x).sum(axis=1)
    plane_bits = np.bitwise_count(pl.numpy().astype(np.uint64)).sum(axis=1)
    np.testing.assert_array_equal(plane_bits, bits)


@pytest.mark.parametrize("length", [14, 24, 40])
def test_planes_match_block_xor(length):
    """mismatch_counts_planes thresholded over the upper triangle == the
    JAX package's XOR block oracle (integers: tolerance 0)."""
    rng = np.random.default_rng(17 + length)
    rows = _words(rng, 500, length)
    r_idx, c_idx, count = hamming_block_xor(
        jnp.asarray(rows), jnp.asarray(rows), 0, 0, 2, cap=1 << 16)
    count = int(count)
    ref = np.stack([np.asarray(r_idx)[:count], np.asarray(c_idx)[:count]])
    ref = ref[:, np.lexsort((ref[1], ref[0]))]
    lanes = torch.from_numpy(rows.view(np.int32))
    d = mismatch_counts_planes(lanes, lanes).numpy()
    a, b = np.nonzero(np.triu(d <= 2, k=1))
    assert count > 0
    np.testing.assert_array_equal(np.stack([a, b]), ref)


@pytest.mark.parametrize("bad", [(1, 0), (-1, 0), (-2, -1)])
@pytest.mark.parametrize("fn", ["wrapper", "plain"])
def test_bad_tile_pair_raises_even_when_disabled(fn, bad):
    """tj < ti or a negative tile raises ValueError from the wrapper and
    from the plain version, whatever the pair's ``on`` flag says."""
    rows = np.zeros((512, 2), np.uint32)
    lanes, tp = _tensors(rows, np.array([(0, 0), bad, (0, 1)]),
                         on=np.array([1, 0, 1], np.int32))
    f = (K.hamming_tile_pairs if fn == "wrapper"
         else K.hamming_tile_pairs_plain)
    with pytest.raises(ValueError, match="0 <= ti <= tj"):
        f(lanes, tp, tile=256, part_stride=512, part_valid=512, max_dist=1)


@pytest.mark.parametrize("stride,valid", [(300, 250), (700, 256), (100, 7)])
def test_stride_not_a_multiple_of_the_tile(stride, valid):
    """A part_stride that no tile divides: the valid rows of a tile are
    no prefix.  Against numpy brute force over the whole table."""
    rng = np.random.default_rng(stride)
    n = 1000  # a ragged last tile as well
    rows = _words(rng, n, 24)
    rows[rng.random(n) < 0.2] = 0  # zero words among the real ones
    ii, jj = np.triu_indices(4)
    lanes, tp = _tensors(rows, np.stack([ii, jj], axis=1))
    a, b = K.hamming_tile_pairs(lanes, tp, tile=256, part_stride=stride,
                                part_valid=valid, max_dist=2)
    z = rows[:, None, :] ^ rows[None, :, :]
    d = np.bitwise_count((z | (z >> np.uint32(1)))
                         & np.uint32(0x55555555)).sum(axis=2)
    ok = np.arange(n) % stride < valid
    ra, rb = np.nonzero(np.triu((d <= 2) & ok[:, None] & ok[None, :], k=1))
    assert len(ra) > 0
    np.testing.assert_array_equal(a.numpy(), ra)
    np.testing.assert_array_equal(b.numpy(), rb)
