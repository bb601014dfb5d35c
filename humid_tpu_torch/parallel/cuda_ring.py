"""Ring-rotated block compare over a local device mesh: the CUDA ring
kernel's wrapper, its plain PyTorch version, the ring schedule and the
function that runs the whole ring.

Counterpart of ``humid_tpu/parallel/pallas_ring.py`` (the TPU kernel
``_ring_kernel`` launched by ``_ring_sweep`` under
``sharded_neighbor_pairs_pallas_ring``).  The kernel is
``humid_tpu_torch/csrc/ring_sweep.cu``; its source note says what bounds
it on the card and what of the TPU kernel it drops.

The unique table ``packed [u, w]`` is cut into ``d`` blocks of
``b = ceil(u / d)`` rows (global index = shard * b + i; rows with global
index >= u are padding and are masked by index, never by their zero
content).  Steps s = 0..d//2 cover every unordered block pair exactly
once (:func:`ring_schedule`): at step s shard ``me`` compares its own
block with block (me + s) mod d, which reached it through s copies
around the ring.

The TPU kernel issues those copies from inside the kernel; here they run
outside it.  Each shard owns one comm slot per step ([steps, b, w] on its
device), a compute stream and a copy stream.  Slot s of shard ``me`` is
copied to slot s + 1 of its left neighbour on a copy stream while the
kernel for step s runs on the compute stream; one event per (shard, slot)
says "slot received".  Every slot is written once and never reused, so
there is no flow control, and all steps of all shards are enqueued
without a host synchronisation.  What travels is the packed block, as on
the TPU: the kernel reads the simplex encoding (``ops/simplex_encode.py``,
12x the bytes at w = 2), so each shard on a card also holds two encoded
blocks, its own (encoded at step 0) and the received one (slot s encoded
on the compute stream once it has arrived, just before step s: stream
order makes the buffer free again for step s + 1), and one zeroed work
counter per step, so that concurrent launches share no counter.  Each
shard appends into one pair buffer through one counter over all its
steps; the counter is read once, and a shard whose count exceeds its
capacity reruns its steps (the slots are still there) with the exact
capacity.  The shards' pairs are merged and
sorted by (a, b) on the host, so the order of the atomic appends never
shows.

On CUDA tensors :func:`ring_block_pairs` launches the kernel or raises;
on CPU tensors, and only there, it runs the plain version in its place.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.cuda_hamming import MAX_LANES, _sorted_keys, _sorted_pairs
from ..ops.hamming import lanes_u32, mismatch_counts
from ..ops.simplex_encode import (encode, pass_threshold, table_rows,
                                  table_width)
from .mesh import data_mesh, pad_to_shards

#: Kernel launches in this process (one per launch of the CUDA kernel,
#: nowhere else); callers reset it to 0 to count one run's launches.
LAUNCHES = 0

#: First pair-buffer capacity (pairs) of one step or one shard's ring; a
#: count beyond it costs one rerun with the exact capacity.
CAP_START = 1 << 22
#: Largest per-shard block (rows) the ring takes by default.
RING_MAX_BLOCK = 1 << 22
#: Elements of one [rows, cols] distance matrix of the plain version.
_PLAIN_ELEMS = 1 << 26


class RingLimitExceeded(ValueError):
    """The per-shard block exceeds the ring's ``block_cap``; callers fall
    back to the dense tile sweep."""


def ring_fits(u: int, d: int | None = None,
              block_cap: int | None = None) -> bool:
    """Would the per-shard block of a ``u``-row table on ``d`` shards (the
    default mesh's size when None) stay within ``block_cap`` (default: the
    ring's block cap)?"""
    if d is None:
        d = len(data_mesh())
    return -(-u // max(d, 1)) <= (block_cap or RING_MAX_BLOCK)


def ring_schedule(d: int) -> list[tuple[int, int, int, bool, bool]]:
    """The ring's work list, step-major: (me, s, q, upper_only, emits) for
    s = 0..d//2 and every shard ``me``; q = (me + s) % d is the block in
    slot s.  s = 0 compares a block with itself (upper triangle only).  On
    an even mesh both ends of {me, me + d/2} meet at the last step, so
    only shards below d/2 emit there.  Every unordered block pair is
    emitted exactly once."""
    steps = d // 2 + 1
    out = []
    for s in range(steps):
        both_ends = d % 2 == 0 and s == steps - 1 and steps > 1
        for me in range(d):
            out.append((me, s, (me + s) % d, s == 0,
                        me < d // 2 if both_ends else True))
    return out


def _check(rows: torch.Tensor, cols: torch.Tensor, row_base: int,
           col_base: int, u: int, max_dist: int, upper_only: bool) -> None:
    for name, t in (("rows", rows), ("cols", cols)):
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D int32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if rows.shape != cols.shape or rows.device != cols.device:
        raise ValueError(f"rows {tuple(rows.shape)} on {rows.device} and "
                         f"cols {tuple(cols.shape)} on {cols.device} differ")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rows.device}")
    if rows.shape[0] < 1 or row_base < 0 or col_base < 0 or max_dist < 0:
        raise ValueError(f"bad ring step b={rows.shape[0]} "
                         f"row_base={row_base} col_base={col_base} "
                         f"max_dist={max_dist}")
    if upper_only and row_base != col_base:
        raise ValueError("upper_only compares a block with itself: "
                         f"row_base {row_base} != col_base {col_base}")
    if u >= 1 << 31:
        raise ValueError(f"{u} rows: pair keys need u < 2^31")


def _valid(base: int, u: int, b: int) -> int:
    """Rows of the b-row block at global index ``base`` that lie below u."""
    return max(0, min(u - base, b))


def ring_block_pairs_plain(rows: torch.Tensor, cols: torch.Tensor, *,
                           row_base: int, col_base: int, u: int,
                           max_dist: int, upper_only: bool):
    """Plain PyTorch version of one ring step (same contract as
    :func:`ring_block_pairs`), on any device: the [b, b] mismatch matrix,
    in row chunks that keep each temporary under 2^26 elements."""
    _check(rows, cols, row_base, col_base, u, max_dist, upper_only)
    dev = rows.device
    b = rows.shape[0]
    n_r, n_c = _valid(row_base, u, b), _valid(col_base, u, b)
    vr, vc = lanes_u32(rows[:n_r]), lanes_u32(cols[:n_c])
    gc = torch.arange(n_c, device=dev)
    chunk = max(1, _PLAIN_ELEMS // max(n_c, 1))
    outs_a, outs_b = [], []
    for r0 in range(0, n_r if n_c else 0, chunk):
        mask = mismatch_counts(vr[r0:r0 + chunk], vc) <= max_dist
        if upper_only:
            gr = torch.arange(r0, min(r0 + chunk, n_r), device=dev)
            mask &= gc[None, :] > gr[:, None]
        ri, ci = mask.nonzero(as_tuple=True)
        ga, gb = row_base + r0 + ri, col_base + ci
        outs_a.append(torch.minimum(ga, gb))
        outs_b.append(torch.maximum(ga, gb))
    if not outs_a:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty.clone()
    return _sorted_pairs(torch.cat(outs_a), torch.cat(outs_b), max(u, 1))


@functools.cache
def _kernel_fn():
    from .. import _build

    fn = _build.load("ring_sweep").humid_ring_sweep
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, p, i64, i32, i64, i32, i64, i64, i64, i32, i32, p, i64,
                   p, p, p]
    fn.restype = ctypes.c_int
    return fn


@dataclass
class _PairBuffer:
    """One shard's pair buffer (one int64 key a * u + b per pair) and its
    64-bit counter."""
    keys: torch.Tensor
    counter: torch.Tensor

    @classmethod
    def new(cls, cap: int, dev: torch.device) -> "_PairBuffer":
        return cls(torch.empty(cap, dtype=torch.int64, device=dev),
                   torch.zeros(1, dtype=torch.int64, device=dev))


def _step(rows, cols, buf: _PairBuffer, *, row_base, col_base, u, max_dist,
          upper_only, tables=None, work=None) -> None:
    """Append one ring step's pairs to ``buf`` and add their number to its
    counter, without a host synchronisation on CUDA: the kernel on the
    current stream for CUDA tensors, over ``tables`` (the encoded
    ``rows`` and ``cols``, :func:`~..ops.simplex_encode.encode`) with
    ``work``, a zeroed one-word work counter of this launch alone (made
    here when not given); on CPU tensors the plain version fills the
    buffer the way the kernel would."""
    global LAUNCHES
    dev = rows.device
    b, w = rows.shape
    if not (_valid(row_base, u, b) and _valid(col_base, u, b)):
        return
    cap = len(buf.keys)
    if dev.type == "cpu":
        a, bb = ring_block_pairs_plain(
            rows, cols, row_base=row_base, col_base=col_base, u=u,
            max_dist=max_dist, upper_only=upper_only)
        n0 = int(buf.counter[0])
        k = max(0, min(cap - n0, len(a)))
        buf.keys[n0:n0 + k] = a[:k] * u + bb[:k]
        buf.counter += len(a)
        return
    if w > MAX_LANES:
        raise ValueError(f"the CUDA ring takes at most {MAX_LANES} lanes "
                         f"(256-base words), got {w}")
    if tables is None:
        raise ValueError("the CUDA ring step reads the encoded blocks: "
                         "pass tables=")
    rt, ct = tables
    if (rt.shape != ct.shape or rt.shape[0] < b
            or rt.shape[1] != table_width(w)):
        raise ValueError(f"encoded blocks {tuple(rt.shape)} and "
                         f"{tuple(ct.shape)} do not hold [{b}, {w}] blocks")
    if work is None:
        work = torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _kernel_fn()(
            rt.data_ptr(), ct.data_ptr(), rt.shape[0], rt.shape[1], b, w,
            row_base, col_base, u, pass_threshold(w, max_dist),
            int(upper_only), buf.keys.data_ptr(), cap,
            buf.counter.data_ptr(), work.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_sweep launch failed: CUDA error {err}")
    LAUNCHES += 1


def ring_block_pairs(rows: torch.Tensor, cols: torch.Tensor, *,
                     row_base: int, col_base: int, u: int, max_dist: int,
                     upper_only: bool, tables=None):
    """One ring step: every (r, c) of the own block ``rows`` [b, w] (global
    index row_base + r) and the received block ``cols`` [b, w] (global
    index col_base + c), int32 tensors holding the uint32 lanes, with both
    global indices < u, at most ``max_dist`` differing bases, and c > r
    when ``upper_only`` (then both are the same block).  Returns (a, b) =
    (min, max) of the global indices, int64 on the input's device, sorted
    by (a, b).  CUDA tensors run the hand-written kernel
    (``csrc/ring_sweep.cu``) over the two blocks' encoded tables
    (``tables``, made here by the CUDA encoder when not given); CPU
    tensors run :func:`ring_block_pairs_plain`."""
    _check(rows, cols, row_base, col_base, u, max_dist, upper_only)
    kw = dict(row_base=row_base, col_base=col_base, u=u, max_dist=max_dist,
              upper_only=upper_only)
    if rows.device.type == "cpu":
        return ring_block_pairs_plain(rows, cols, **kw)
    if tables is None:
        enc = encode(rows)
        tables = (enc, enc if cols is rows else encode(cols))
    kw["tables"] = tables
    buf = _PairBuffer.new(min(CAP_START, rows.shape[0] ** 2), rows.device)
    _step(rows, cols, buf, **kw)
    n = int(buf.counter.item())
    if n > len(buf.keys):
        buf = _PairBuffer.new(n, rows.device)
        _step(rows, cols, buf, **kw)
    return _sorted_keys(buf.keys[:n], max(u, 1))


@dataclass
class RingSlots:
    """One shard's side of the ring's data movement, whatever travels: its
    comm slots and, on CUDA, its two streams and the "slot received"
    events.  The Hamming ring puts its pair buffer beside it; the dense
    edit ring (``neighbors.sharded_neighbor_pairs``) uses it as it is."""
    dev: torch.device
    slots: torch.Tensor  # [steps, *block.shape]; slot 0 is the own block
    compute: "torch.cuda.Stream | None" = None
    copy: "torch.cuda.Stream | None" = None
    received: list = field(default_factory=list)  # one event per slot

    def _on(self, stream):
        """Context that makes ``stream`` current (nothing on the CPU)."""
        if stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(stream)

    def forward(self, dst: "RingSlots", s: int) -> None:
        """Copy slot s into slot s + 1 of ``dst`` on the copy streams,
        after slot s was received; record "slot s + 1 received"."""
        if dst.copy is None:
            dst.slots[s + 1].copy_(self.slots[s])
            return
        with dst._on(dst.copy):
            dst.copy.wait_event(self.received[s])
            # A copy between two cards runs on the source card's current
            # stream and is ordered into the destination's: make both the
            # copy streams.
            other = self.copy if self.dev != dst.dev else None
            with self._on(other):
                if other is not None:
                    other.wait_event(self.received[s])
                dst.slots[s + 1].copy_(self.slots[s], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(dst.copy)
            dst.received[s + 1] = ev

    @contextlib.contextmanager
    def computing(self, s: int):
        """Context of step s's compute: the compute stream is current and
        has waited for slot s."""
        with self._on(self.compute):
            if self.compute is not None:
                self.compute.wait_event(self.received[s])
            yield

    def join(self) -> None:
        """Make the device's current stream wait for the shard's two
        streams, so what follows on it is ordered after the ring and the
        slots outlive the copies that read them."""
        if self.compute is not None:
            cur = torch.cuda.current_stream(self.dev)
            cur.wait_stream(self.compute)
            cur.wait_stream(self.copy)


def ring_slots(block: torch.Tensor, steps: int,
               dev: torch.device) -> RingSlots:
    """``steps`` comm slots of ``block``'s shape and type on ``dev`` with
    ``block`` in slot 0, and the shard's streams.  Allocate whatever else
    the shard's streams will touch before this call: a side stream may
    only touch memory whose allocation the ``received`` event of slot 0 is
    ordered after."""
    with torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext():
        slots = torch.empty((steps, *block.shape), dtype=block.dtype,
                            device=dev)
        slots[0].copy_(block)
        sh = RingSlots(dev, slots)
        if dev.type == "cuda":
            sh.compute, sh.copy = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
            sh.compute.wait_event(ready)
            sh.copy.wait_event(ready)
            sh.received = [ready] + [None] * (steps - 1)
    return sh


@dataclass
class _Shard:
    """One shard of the Hamming ring: its pair buffer, its slots and, on
    CUDA, its two encoded blocks (own, received) and the steps' work
    counters."""
    buf: _PairBuffer
    ring: RingSlots
    own: "torch.Tensor | None" = None
    received: "torch.Tensor | None" = None
    work: "torch.Tensor | None" = None

    @classmethod
    def new(cls, cap: int, block: torch.Tensor, steps: int,
            dev: torch.device) -> "_Shard":
        """The buffers first, then the slots (:func:`ring_slots`: the
        shard's streams touch only memory allocated before them)."""
        buf = _PairBuffer.new(cap, dev)
        own = received = work = None
        if dev.type == "cuda":
            shape = (table_rows(len(block)), table_width(block.shape[1]))
            own = torch.empty(shape, dtype=torch.int8, device=dev)
            if steps > 1:
                received = torch.empty(shape, dtype=torch.int8, device=dev)
            work = torch.zeros(steps, dtype=torch.int64, device=dev)
        return cls(buf, ring_slots(block, steps, dev), own, received, work)

    def step_args(self, s: int) -> dict:
        """The kernel's arguments of step s beside the blocks, encoding on
        the current stream what it reads: the own block at step 0, slot s
        into the received buffer at a later step.  Nothing on the CPU,
        where the plain version reads the packed blocks."""
        if self.own is None:
            return {}
        if s == 0:
            encode(self.ring.slots[0], out=self.own)
            return {"tables": (self.own, self.own), "work": self.work[0]}
        encode(self.ring.slots[s], out=self.received)
        return {"tables": (self.own, self.received), "work": self.work[s]}


def _count(sh: _Shard) -> int:
    """The shard's match count, read once after all its work (the sort
    and a rerun are ordered after the ring by :meth:`RingSlots.join`)."""
    sh.ring.join()
    return int(sh.buf.counter.item())


def ring_shard_keys(packed: np.ndarray, max_dist: int, *, mesh,
                    block_cap: int | None = None) -> list[torch.Tensor]:
    """Run the whole ring over ``packed`` [u, w] (u >= 2) on ``mesh``:
    each shard's pairs as int64 keys a * u + b, a < b, in the order of its
    atomics, left on the shard's device.  Raises
    :class:`RingLimitExceeded` for a block above ``block_cap``."""
    d = len(mesh)
    u, w = packed.shape
    if u >= 1 << 31:
        raise ValueError(f"{u} rows: pair keys need u < 2^31")
    b = -(-u // d)
    if not ring_fits(u, d, block_cap):
        raise RingLimitExceeded(
            f"per-shard block {b} exceeds block_cap "
            f"{block_cap or RING_MAX_BLOCK}; shard the table first")
    steps = d // 2 + 1
    lanes = torch.from_numpy(np.ascontiguousarray(
        pad_to_shards(packed, d, multiple=1), np.uint32).view(np.int32))
    cap = min(CAP_START, steps * b * b)
    shards = [_Shard.new(cap, lanes[me * b:(me + 1) * b], steps, dev)
              for me, dev in enumerate(mesh)]
    schedule = ring_schedule(d)

    def step_kw(me, q, upper_only):
        return dict(row_base=me * b, col_base=q * b, u=u, max_dist=max_dist,
                    upper_only=upper_only)

    # Step-major: every "slot received" event is recorded before the
    # iteration that waits for it.
    for me, s, q, upper_only, emits in schedule:
        sh = shards[me]
        if s + 1 < steps:
            sh.ring.forward(shards[(me - 1) % d].ring, s)
        if emits:
            with sh.ring.computing(s):
                _step(sh.ring.slots[0], sh.ring.slots[s], sh.buf,
                      **sh.step_args(s), **step_kw(me, q, upper_only))

    keys = []
    for me, sh in enumerate(shards):
        n = _count(sh)
        if n > len(sh.buf.keys):
            # Exact-capacity rerun of this shard's steps on the slots it
            # still holds, on the device's current stream, with fresh work
            # counters.
            sh.buf = _PairBuffer.new(n, sh.ring.dev)
            if sh.work is not None:
                sh.work = torch.zeros_like(sh.work)
            for me2, s, q, upper_only, emits in schedule:
                if me2 == me and emits:
                    _step(sh.ring.slots[0], sh.ring.slots[s], sh.buf,
                          **sh.step_args(s), **step_kw(me, q, upper_only))
        keys.append(sh.buf.keys[:n])
    return keys


def sharded_neighbor_pairs_ring(
    packed: np.ndarray,
    max_dist: int,
    *,
    word_length: int | None = None,
    mesh=None,
    cap_row: int = 16,
    block_cap: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Mesh Hamming neighbour pairs through the ring kernel: (a, b) int64,
    a < b, sorted by (a, b), the contract of ``find_neighbor_pairs`` and
    of the reference's ``sharded_neighbor_pairs_pallas_ring``.

    ``mesh`` is a tuple of devices, one per shard (default:
    ``data_mesh(device=device)``).  A per-shard block above ``block_cap``
    (default 2^22 rows) raises :class:`RingLimitExceeded`.  ``cap_row``
    and ``word_length`` are accepted for the reference's signature and
    ignored: the kernel's output has no per-row cap."""
    del cap_row, word_length
    mesh = mesh or data_mesh(device=device)
    u = len(packed)
    if u <= 1 or max_dist == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    parts = [k.cpu().numpy() for k in ring_shard_keys(
        packed, max_dist, mesh=mesh, block_cap=block_cap)]
    # Shards emit disjoint sets of keys a * u + b in the order of their
    # atomics; one sort on the host merges them into the (a, b) order.
    key = np.sort(np.concatenate(parts))
    return key // u, key % u
