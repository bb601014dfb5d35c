"""The tile sweep K1's integer encoding (humid_tpu_torch.ops.cuda_hamming:
``encode_table``, ``pass_threshold``, ``table_width``) against the JAX
package.

The CUDA kernel computes every distance as the int8 product of two rows
of the encoded table on the tensor cores and passes a pair when that
product reaches ``pass_threshold``.  Here the same products are taken
with PyTorch on the CPU and held against the JAX package's
``_mismatch_counts`` and, for whole tile-pair lists, its Pallas kernel
in interpret mode (as its own tests run it).  Inputs are made with numpy
from fixed seeds.  Everything is integer: tolerance 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from humid_tpu.ops import neighbors as JN
from humid_tpu.ops.hamming import _mismatch_counts
from humid_tpu_torch import words as W
from humid_tpu_torch.ops import cuda_hamming as K


def _table_words(rng, w: int) -> np.ndarray:
    """[N, w] uint32 words of every kind the kernel meets: random lanes,
    all-A (zero) and all-T (all ones) words, words shorter than 16 w
    bases (padding slots: code A), and near copies of each other."""
    rand = rng.integers(0, 2**32, (40, w), dtype=np.uint64).astype(np.uint32)
    short = []
    for length in sorted({1, max(1, 16 * w - 5), 16 * w // 2, 16 * w}):
        codes = rng.integers(0, 4, (6, length), dtype=np.uint8)
        codes[1] = codes[0]
        codes[1, rng.integers(0, length)] ^= 1  # one substitution
        short.append(W.pack_words(codes).reshape(6, -1)[:, :w])
        if short[-1].shape[1] < w:
            short[-1] = np.pad(short[-1], ((0, 0), (0, w - short[-1].shape[1])))
    special = np.stack([np.zeros(w, np.uint32),
                        np.full(w, 0xFFFFFFFF, np.uint32)])
    near = rand[:10].copy()
    near[:, 0] ^= np.uint32(0x3)  # the last base of lane 0 changed
    return np.ascontiguousarray(np.concatenate([rand, *short, special, near]),
                                dtype=np.uint32)


def _products(words: np.ndarray) -> torch.Tensor:
    """The kernel's int32 sums: encoded rows x encoded rows."""
    table = K.encode_table(torch.from_numpy(words.view(np.int32)))
    enc = table[:len(words)].to(torch.int64)
    return enc @ enc.T


@pytest.mark.parametrize("w", range(1, K.MAX_LANES + 1))
def test_encoded_product_gives_the_jax_distances(w):
    rng = np.random.default_rng(300 + w)
    words = _table_words(rng, w)
    dist = np.asarray(_mismatch_counts(jnp.asarray(words),
                                       jnp.asarray(words)))
    acc = _products(words).numpy()
    # acc = 4 * matches - 16 w over all 16 w slots = 48 w - 4 * distance.
    np.testing.assert_array_equal(acc, 48 * w - 4 * dist)
    assert dist.max() == 16 * w  # all-A against all-T
    assert (np.diag(acc) == 48 * w).all()


def test_simplex_channels_are_exact():
    """Equal bases give 3, different bases -1: the product counts
    matches exactly, and encode_table writes these channels."""
    ch = np.array(K.SIMPLEX)
    np.testing.assert_array_equal(ch @ ch.T, 4 * np.eye(4) - 1)
    codes = np.arange(4, dtype=np.uint8)[:, None].repeat(16, axis=1)
    table = K.encode_table(torch.from_numpy(W.pack_words(codes).view(
        np.int32)))
    np.testing.assert_array_equal(table[:4, :3].numpy(), ch)
    np.testing.assert_array_equal(table[:4, 45:48].numpy(), ch)


_MAX_DISTS = {"minus_1": lambda w: -1, "0": lambda w: 0, "1": lambda w: 1,
              "word_minus_1": lambda w: 16 * w - 1,
              "word": lambda w: 16 * w, "word_plus_5": lambda w: 16 * w + 5}


@pytest.mark.parametrize("which", list(_MAX_DISTS))
@pytest.mark.parametrize("w", [1, 2, 3, 7, 16])
def test_pass_threshold_is_the_distance_test(w, which):
    max_dist = _MAX_DISTS[which](w)
    rng = np.random.default_rng(40 + w)
    words = _table_words(rng, w)
    dist = np.asarray(_mismatch_counts(jnp.asarray(words),
                                       jnp.asarray(words)))
    passes = _products(words).numpy() >= K.pass_threshold(w, max_dist)
    np.testing.assert_array_equal(passes, dist <= max_dist)
    if max_dist < 0:
        assert not passes.any()
    if max_dist >= 16 * w:
        assert passes.all()


@pytest.mark.parametrize("n", [1, 63, 64, 65, 700])
@pytest.mark.parametrize("w", [1, 2, 3, 16])
def test_table_padding(w, n):
    """K a multiple of 32 (48 w rounded up), rows a multiple of the
    kernel's 64 (at least 64), zero past n rows and past 48 w columns;
    every channel of a real row is +-1."""
    rng = np.random.default_rng(n * 17 + w)
    words = rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)
    table = K.encode_table(torch.from_numpy(words.view(np.int32)))
    k = K.table_width(w)
    assert k % 32 == 0 and 48 * w <= k < 48 * w + 32
    assert table.dtype == torch.int8 and table.is_contiguous()
    assert table.shape == (max(-(-n // K.TABLE_ROWS), 1) * K.TABLE_ROWS, k)
    assert not table[n:].any() and not table[:, 48 * w:].any()
    assert bool((table[:n, :48 * w].abs() == 1).all())


def _kernel_arithmetic(lanes, tile_pairs, *, tile, part_stride, part_valid,
                       max_dist):
    """The kernel's decisions on the CPU: per tile pair the encoded rows'
    products against pass_threshold, then validity, the upper triangle
    of a diagonal tile pair; keys sorted as the wrapper sorts them."""
    n, w = lanes.shape
    enc = K.encode_table(lanes).to(torch.int64)
    thr = K.pass_threshold(w, max_dist)
    keys = []
    for ti, tj, on in tile_pairs.tolist():
        if not on:
            continue
        r = torch.arange(ti * tile, min((ti + 1) * tile, n))
        c = torch.arange(tj * tile, min((tj + 1) * tile, n))
        ok = (enc[r] @ enc[c].T) >= thr
        ok &= (r % part_stride < part_valid)[:, None]
        ok &= (c % part_stride < part_valid)[None, :]
        if ti == tj:
            ok &= c[None, :] > r[:, None]
        ri, ci = ok.nonzero(as_tuple=True)
        keys.append(r[ri] * n + c[ci])
    key = torch.sort(torch.cat(keys)).values
    return key // n, key % n


# Two partitions of 512 rows, 400 of them real, in tiles of 256: the
# stacked layout of the bucketed engine.
_PAIRS = np.array([(0, 0), (0, 1), (1, 1), (2, 2), (2, 3), (3, 3)],
                  np.int32)


@pytest.mark.parametrize("max_dist", [1, 3])
@pytest.mark.parametrize("length", [14, 24, 40])  # w = 1, 2, 3
def test_kernel_arithmetic_matches_pallas(length, max_dist):
    """The whole sweep by the encoded products == the JAX package's
    Pallas kernel (interpret mode) == the plain version."""
    rng = np.random.default_rng(900 + length + max_dist)
    base = rng.integers(0, 4, (30, length), dtype=np.uint8)
    codes = base[rng.integers(0, 30, 1024)]
    mut = rng.random(1024) < 0.6
    codes[np.flatnonzero(mut), rng.integers(0, length, int(mut.sum()))] = (
        rng.integers(0, 4, int(mut.sum()), dtype=np.uint8))
    rows = W.pack_words(codes)
    run = JN._pallas_chunked_run(rows, _PAIRS, 512, 400, max_dist,
                                 tile=256, interpret=True)
    ja, jb = JN._extract_with_retry(run, 1024, 256, 16, 1 << 20)
    tp = np.ones((len(_PAIRS), 3), np.int32)
    tp[:, :2] = _PAIRS
    lanes, tp = torch.from_numpy(rows.view(np.int32)), torch.from_numpy(tp)
    kw = dict(tile=256, part_stride=512, part_valid=400, max_dist=max_dist)
    a, b = _kernel_arithmetic(lanes, tp, **kw)
    assert len(ja) > 0
    np.testing.assert_array_equal(a.numpy(), ja)
    np.testing.assert_array_equal(b.numpy(), jb)
    pa, pb = K.hamming_tile_pairs_plain(lanes, tp, **kw)
    assert torch.equal(a, pa) and torch.equal(b, pb)


def test_k1_variants_apply_to_the_source():
    """Every design variant that tools/k1_variants.py builds still finds
    its text once in csrc/hamming_sweep.cu and the pipeline it includes,
    csrc/tc_sweep.cuh (a replacement that no longer matches would raise
    on the card)."""
    from humid_tpu_torch import _build
    from humid_tpu_torch.tools.k1_variants import SOURCES, VARIANTS

    src = "".join((_build.CSRC / f).read_text() for f in SOURCES)
    for name, (encoding, replacements) in VARIANTS.items():
        assert encoding in ("simplex", "onehot"), name
        for old, _ in replacements:
            assert src.count(old) == 1, (name, old)


@pytest.mark.parametrize("encoding", ["simplex", "onehot"])
@pytest.mark.parametrize("w", [1, 2, 3])
def test_k1_variant_tables_give_the_distance_test(encoding, w):
    """The tables and thresholds the variant tool gives its kernels: the
    one-hot table's products count matches over all 16 w slots."""
    from humid_tpu_torch.tools.k1_variants import table_for

    words = _table_words(np.random.default_rng(70 + w), w)
    dist = np.asarray(_mismatch_counts(jnp.asarray(words),
                                       jnp.asarray(words)))
    table, thr = table_for(encoding, torch.from_numpy(words.view(np.int32)))
    assert table.shape[0] % K.TABLE_ROWS == 0 and table.shape[1] % 32 == 0
    enc = table[:len(words)].to(torch.int64)
    acc = (enc @ enc.T).numpy()
    for max_dist in (-1, 0, 1, 3, 16 * w):
        np.testing.assert_array_equal(acc >= thr(max_dist),
                                      dist <= max_dist)
