"""The ring step K2's integer arithmetic (humid_tpu_torch.parallel.cuda_ring
over humid_tpu_torch.ops.simplex_encode) against the plain step and the
JAX package's Pallas ring.

The CUDA kernel matches the own block against the received one as int8
products of their encoded tables on the tensor cores, passes a pair when
the product reaches ``pass_threshold``, masks rows and columns by their
global index (< u), keeps c > r on the step that compares a block with
itself, and writes the key min * u + max.  Here each ring step is
computed that way with PyTorch on the CPU and held against
``ring_block_pairs_plain`` and, for whole rings, against the JAX
package's ``sharded_neighbor_pairs_pallas_ring`` in interpret mode on its
virtual CPU mesh (as tests/test_torch_parallel.py runs it).  Inputs are
made with numpy from fixed seeds.  Everything is integer: tolerance 0.
"""

import numpy as np
import pytest
import torch

from humid_tpu import parallel as JP
from humid_tpu_torch import parallel as P
from humid_tpu_torch import words as W
from humid_tpu_torch.ops import simplex_encode as E
from humid_tpu_torch.ops import unique_words
from humid_tpu_torch.parallel import cuda_ring as R
from humid_tpu_torch.parallel.mesh import pad_to_shards


def _uniq(rng, n, length, pool):
    """Unique packed words of ``n`` reads drawn from ``pool`` templates
    with one random substitution in 70% of them."""
    base = rng.integers(0, 4, size=(pool, length)).astype(np.uint8)
    codes = base[rng.integers(0, pool, n)].copy()
    muts = rng.integers(0, length, n)
    flip = rng.random(n) < 0.7
    codes[np.arange(n)[flip], muts[flip]] = rng.integers(0, 4, flip.sum())
    return unique_words(W.pack_words(codes), want_inverse=False)[0]


def _blocks(uniq, d):
    """The ring's d blocks of b rows as int32 tensors (rows past u zero)."""
    b = -(-len(uniq) // d)
    lanes = torch.from_numpy(np.ascontiguousarray(
        pad_to_shards(uniq, d, multiple=1), np.uint32).view(np.int32))
    return b, [lanes[i * b:(i + 1) * b] for i in range(d)]


def _kernel_step(rows, cols, *, row_base, col_base, u, max_dist,
                 upper_only):
    """One step as the kernel decides it: the encoded blocks' products
    against pass_threshold, rows and columns valid by global index, c > r
    when upper_only, keys min * u + max sorted as the wrapper sorts."""
    b, w = rows.shape
    enc_r = E.encode_table(rows).to(torch.int64)
    enc_c = E.encode_table(cols).to(torch.int64)
    ok = (enc_r @ enc_c.T) >= E.pass_threshold(w, max_dist)
    r = torch.arange(ok.shape[0])
    c = torch.arange(ok.shape[1])
    ok &= (row_base + r < u)[:, None] & (r < b)[:, None]
    ok &= (col_base + c < u)[None, :] & (c < b)[None, :]
    if upper_only:
        ok &= c[None, :] > r[:, None]
    ri, ci = ok.nonzero(as_tuple=True)
    ga, gb = row_base + ri, col_base + ci
    key = torch.sort(torch.minimum(ga, gb) * u + torch.maximum(ga, gb)).values
    return key // u, key % u


def _ring(uniq, d, max_dist):
    """Every emitting step of the ring schedule, each by the kernel's
    arithmetic and by the plain step (held equal), merged."""
    u = len(uniq)
    b, blocks = _blocks(uniq, d)
    keys, wrapped = [], 0
    for me, s, q, upper_only, emits in R.ring_schedule(d):
        if not emits:
            continue
        kw = dict(row_base=me * b, col_base=q * b, u=u, max_dist=max_dist,
                  upper_only=upper_only)
        got = _kernel_step(blocks[me], blocks[q], **kw)
        want = R.ring_block_pairs_plain(blocks[me], blocks[q], **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert bool((got[0] < got[1]).all())
        keys.append(got[0] * u + got[1])
        wrapped += q < me
    key = torch.sort(torch.cat(keys)).values
    return (key // u).numpy(), (key % u).numpy(), wrapped


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("length", [16, 24, 40])  # w = 1, 2, 3
@pytest.mark.parametrize("d", [1, 2, 3, 5])
def test_kernel_step_arithmetic_matches_plain(d, length, m):
    """Every step of the ring (the diagonal step, wrapped blocks with
    q < me, the last block cut by u) by the encoded products equals the
    plain step; the merged ring equals the dense plain sweep."""
    rng = np.random.default_rng(1400 + 10 * d + length + m)
    uniq = _uniq(rng, 500, length, pool=60)
    if d > 1 and len(uniq) % d == 0:
        uniq = uniq[:-1]  # the last block is cut by u
    u = len(uniq)
    a, b, wrapped = _ring(uniq, d, m)
    assert (wrapped > 0) == (d >= 3)  # a block from below the own one
    assert len(a) > 0
    lanes = torch.from_numpy(uniq.view(np.int32))
    dense = R.ring_block_pairs_plain(lanes, lanes, row_base=0, col_base=0,
                                     u=u, max_dist=m, upper_only=True)
    np.testing.assert_array_equal(a, dense[0].numpy())
    np.testing.assert_array_equal(b, dense[1].numpy())


@pytest.mark.parametrize("d,length,m", [(1, 16, 1), (2, 24, 2), (3, 40, 1),
                                        (5, 24, 1), (3, 16, 2), (5, 40, 2)])
def test_kernel_ring_arithmetic_matches_pallas_ring(d, length, m):
    """The whole ring by the encoded products == the JAX package's Pallas
    ring (interpret mode, virtual CPU mesh) == the port's ring on d CPU
    shards."""
    rng = np.random.default_rng(1500 + 10 * d + length + m)
    uniq = _uniq(rng, 400, length, pool=50)
    a, b, _ = _ring(uniq, d, m)
    ja, jb = JP.sharded_neighbor_pairs_pallas_ring(
        uniq, m, word_length=length, mesh=JP.data_mesh(d), cap_row=4)
    assert len(ja) > 0
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    pa, pb = P.sharded_neighbor_pairs_ring(uniq, m, word_length=length,
                                           mesh=P.data_mesh(d, "cpu"))
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(pb, jb)


@pytest.mark.parametrize("factor", [12, 13, 16, 20])
@pytest.mark.parametrize("w", [1, 2, 3])
def test_kernel_step_threshold_at_or_below_zero(w, factor):
    """max_dist >= 12 w: pass_threshold is 0 or below, so the zero rows
    of the encoded tables (past b, up to the multiple of 64) would pass,
    and so would the padding rows below b; only the index masks keep
    them out, and every valid pair passes once max_dist >= 16 w."""
    max_dist = factor * w
    assert E.pass_threshold(w, max_dist) <= 0
    rng = np.random.default_rng(60 + 7 * w + factor)
    b, u = 100, 170  # the second block holds 70 rows below u
    words = rng.integers(0, 2**32, (2 * b, w),
                         dtype=np.uint64).astype(np.uint32)
    words[u:] = 0  # padding rows, as pad_to_shards leaves them
    rows = torch.from_numpy(words[:b].view(np.int32))
    cols = torch.from_numpy(words[b:].view(np.int32))
    enc = E.encode_table(cols)
    assert enc.shape[0] > b and not enc[b:].any()  # zero rows exist
    for kw in (dict(row_base=0, col_base=b, upper_only=False),
               dict(row_base=b, col_base=b, upper_only=True)):
        src = cols if kw["upper_only"] else rows
        got = _kernel_step(src, cols, u=u, max_dist=max_dist, **kw)
        want = R.ring_block_pairs_plain(src, cols, u=u, max_dist=max_dist,
                                        **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(got[1].max()) < u
        if factor >= 16:
            n_r = u - kw["row_base"] if kw["upper_only"] else b
            n_c = u - b
            assert len(got[0]) == (n_c * (n_c - 1) // 2 if kw["upper_only"]
                                   else n_r * n_c)


def test_wrapped_block_keys_are_min_max():
    """A wrapped step (q < me: the received block lies below the own one)
    writes each pair as (min, max) of the global indices."""
    rng = np.random.default_rng(77)
    uniq = _uniq(rng, 600, 24, pool=20)
    d = 3
    b, blocks = _blocks(uniq, d)
    kw = dict(row_base=2 * b, col_base=0, u=len(uniq), max_dist=2,
              upper_only=False)
    a, bb = _kernel_step(blocks[2], blocks[0], **kw)
    assert len(a) > 0
    assert bool((a < b).all()) and bool((bb >= 2 * b).all())
    want = R.ring_block_pairs_plain(blocks[2], blocks[0], **kw)
    assert torch.equal(a, want[0]) and torch.equal(bb, want[1])


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 300])
@pytest.mark.parametrize("w", [1, 2, 3, 16])
def test_encode_on_cpu_is_encode_table(w, n):
    """The encoder's wrapper on a CPU tensor is its plain version, into a
    given buffer too; a wrong buffer raises."""
    rng = np.random.default_rng(n * 31 + w)
    words = rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)
    lanes = torch.from_numpy(words.view(np.int32))
    want = E.encode_table(lanes)
    assert want.shape == (E.table_rows(n), E.table_width(w))
    before = E.LAUNCHES
    assert torch.equal(E.encode(lanes), want)
    out = torch.full(want.shape, 5, dtype=torch.int8)
    assert E.encode(lanes, out=out) is out and torch.equal(out, want)
    assert E.LAUNCHES == before  # no kernel on the CPU
    with pytest.raises(ValueError):
        E.encode(lanes, out=torch.empty((want.shape[0] + 64, want.shape[1]),
                                        dtype=torch.int8))
    with pytest.raises(ValueError):
        E.encode(lanes.to(torch.int64))


def test_shard_encodes_own_block_then_each_received_slot():
    """The ring's encoding schedule (what _Shard.step_args enqueues on
    the compute stream before each step; on the card only, so driven here
    with CPU buffers): step 0 encodes the own block and reads it on both
    sides, a later step encodes its slot into the received buffer, and
    each step gets its own work counter."""
    rng = np.random.default_rng(5)
    block = torch.from_numpy(rng.integers(0, 2**32, (70, 2), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
    steps = 3
    ring = R.ring_slots(block, steps, torch.device("cpu"))
    for s in range(1, steps):
        ring.slots[s] = torch.from_numpy(
            rng.integers(0, 2**32, (70, 2), dtype=np.uint64)
            .astype(np.uint32).view(np.int32))
    shape = (E.table_rows(70), E.table_width(2))
    sh = R._Shard(R._PairBuffer.new(16, torch.device("cpu")), ring,
                  own=torch.empty(shape, dtype=torch.int8),
                  received=torch.empty(shape, dtype=torch.int8),
                  work=torch.zeros(steps, dtype=torch.int64))
    args = sh.step_args(0)
    assert args["tables"][0] is sh.own and args["tables"][1] is sh.own
    assert torch.equal(sh.own, E.encode_table(block))
    for s in range(1, steps):
        args = sh.step_args(s)
        assert args["tables"] == (sh.own, sh.received)
        assert torch.equal(sh.received, E.encode_table(ring.slots[s]))
        assert args["work"].data_ptr() == sh.work[s].data_ptr()
    assert torch.equal(sh.own, E.encode_table(block))  # read-only since
    cpu = R._Shard.new(16, block, steps, torch.device("cpu"))
    assert cpu.own is None and cpu.step_args(1) == {}
