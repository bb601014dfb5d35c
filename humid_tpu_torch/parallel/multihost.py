"""Multi-process orchestration over ``torch.distributed``.

Counterpart of ``humid_tpu/parallel/multihost.py``, which rides
``jax.distributed``.  Each process ingests a contiguous record range of
every input file (all files in lockstep, so tuples stay aligned), packs
its words and counts its unique ones, and the processes exchange only
those tables, their neighbour pairs and their cluster rows — never raw
FastQ.

Every payload of this layer is a host numpy array (so it is in the
reference: ``process_allgather`` of host arrays), so the process group
is ``gloo`` on the CPU and on the card alike.  NCCL would move device
tensors between cards and refuses two ranks on one card, which is how a
one-card machine runs several processes.

``init_distributed`` starts the group from an explicit coordinator
address, world size and rank (nothing on the machine tells a process of
its peers).  ``all_gather`` arguments are injectable everywhere, so one
process can simulate several hosts in the tests.
"""

from __future__ import annotations

import datetime

import numpy as np

#: Timeout of the process group and of its barriers: hosts legitimately
#: skew by minutes at scale (a gzip range spill inflates the stream up to
#: the host's range end, so the last host inflates all of it).
TIMEOUT_S = 7200.0

_STORE = None
_BARRIER_CALLS: dict[str, int] = {}


def _dist():
    import torch.distributed as dist

    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The group's world size (1 without a group)."""
    return _dist().get_world_size() if _initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return _dist().get_rank() if _initialized() else 0


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join the ``gloo`` process group at ``coordinator`` (HOST:PORT;
    process 0 serves the rendezvous store there) as rank ``process_id`` of
    ``num_processes``; a no-op when a group exists.

    A missing or inconsistent configuration raises ValueError (the CLI
    prints it as a usage error).  The store and the group time out after
    TIMEOUT_S, and one warm-up gather runs while every process stands at
    the same early point, so that later skew meets an established group."""
    dist = _dist()
    if _initialized():
        return
    global _STORE
    if coordinator is None:
        raise ValueError("a multi-process run needs --coordinator HOST:PORT")
    if num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs --num-processes and "
                         "--process-id")
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is not in "
                         f"[0, {num_processes})")
    host, sep, port = coordinator.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"--coordinator {coordinator!r} is not HOST:PORT")
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    _STORE = dist.TCPStore(host, int(port), num_processes,
                           is_master=process_id == 0, timeout=timeout)
    dist.init_process_group("gloo", store=_STORE, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    if num_processes > 1:
        default_all_gather([np.zeros(1, np.int64)])


def coordination_barrier(name: str, timeout_s: float = TIMEOUT_S) -> None:
    """Block until every process reaches the barrier ``name``, on the
    rendezvous store (not a collective): where per-process work before a
    collective is skewed by many minutes, as after the gzip range spill.
    Each call of a name is a new barrier (every process calls them in the
    same order).  A no-op without a group (one process, or injected
    gathers)."""
    if _STORE is None or process_count() == 1:
        return
    n = _BARRIER_CALLS[name] = _BARRIER_CALLS.get(name, 0) + 1
    key = f"humid_tpu_torch/{name}/{n}"
    if _STORE.add(f"{key}/arrived", 1) == process_count():
        _STORE.set(f"{key}/done", b"1")
    _STORE.wait([f"{key}/done"], datetime.timedelta(seconds=timeout_s))


def default_barrier() -> None:
    """Barrier over every process of the group (no-op for one process)."""
    if process_count() > 1:
        _dist().barrier()


def host_record_range(total_records: int, process_id: int | None = None,
                      num_processes: int | None = None) -> tuple[int, int]:
    """[lo, hi) record-tuple range owned by this process: an even split
    with the remainder on the last one (the reference's
    remainder-to-last budgeting convention, fastq.cc:220-230)."""
    p = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    per = total_records // n
    lo = p * per
    hi = total_records if p == n - 1 else lo + per
    return lo, hi


def global_unique_index(uniq_g: np.ndarray,
                        packed_local: np.ndarray) -> np.ndarray:
    """Row index in the (sorted) global unique table of every local
    packed word; every local word is in the global table by
    construction."""
    w = uniq_g.shape[1]
    if w <= 2:
        kg = uniq_g[:, 0].astype(np.uint64) << np.uint64(32)
        kl = packed_local[:, 0].astype(np.uint64) << np.uint64(32)
        if w == 2:
            kg |= uniq_g[:, 1].astype(np.uint64)
            kl |= packed_local[:, 1].astype(np.uint64)
    else:
        dt = np.dtype([(f"l{i}", np.uint32) for i in range(w)])
        kg = np.ascontiguousarray(uniq_g).view(dt).ravel()
        kl = np.ascontiguousarray(packed_local).view(dt).ravel()
    return np.searchsorted(kg, kl)


def default_all_gather(arrs):
    """Gather a list of arrays from every process: returns, per array,
    the list of every process's array (in rank order).  Processes send
    arrays of different lengths, so the lengths go first (one gather for
    all arrays), then each array padded to the longest, as the bytes of
    its rows (gloo moves uint8 whatever the dtype, and the bits come back
    unchanged: uint32 tables, bool, float64), trimmed and viewed back."""
    import torch

    dist = _dist()
    n = process_count()
    arrs = [np.ascontiguousarray(a) for a in arrs]
    lens = torch.tensor([len(a) for a in arrs], dtype=torch.int64)
    lens_all = [torch.empty_like(lens) for _ in range(n)]
    dist.all_gather(lens_all, lens)
    lens_all = torch.stack(lens_all).numpy()  # [P, n_arrays]
    out = []
    for i, a in enumerate(arrs):
        row = a.dtype.itemsize * int(np.prod(a.shape[1:], dtype=np.int64))
        maxlen = int(lens_all[:, i].max())
        if maxlen == 0 or row == 0:  # every process sends nothing
            out.append([np.zeros((int(lens_all[p, i]),) + a.shape[1:],
                                 a.dtype) for p in range(n)])
            continue
        buf = np.zeros((maxlen, row), np.uint8)
        buf[:len(a)] = a.view(np.uint8).reshape(len(a), row)
        mine = torch.from_numpy(buf)
        got = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(got, mine)
        out.append([np.ascontiguousarray(g.numpy()[:int(lens_all[p, i])])
                    .view(a.dtype).reshape((int(lens_all[p, i]),)
                                           + a.shape[1:])
                    for p, g in enumerate(got)])
    return out


def merge_unique_tables(uniq: np.ndarray, counts: np.ndarray,
                        first_occ: np.ndarray, *, all_gather=None):
    """Merge every process's unique table into the global one.

    ``uniq`` [u_local, W] uint32 (sorted), ``counts`` [u_local],
    ``first_occ`` [u_local] global read indices of the local first
    occurrences.  Returns (uniq_g [U, W], counts_g [U], first_occ_g [U])
    with counts summed and the smallest first occurrence kept per word:
    what one process gets over the whole input (the representative-read
    rule of humid.cc:224-231 depends on it).  ``all_gather`` defaults to
    :func:`default_all_gather`."""
    if all_gather is None:
        all_gather = default_all_gather
    uniq_all, counts_all, first_all = all_gather([uniq, counts, first_occ])
    return combine_unique_tables(uniq_all, counts_all, first_all)


def combine_unique_tables(uniq_all, counts_all, first_all):
    """Pure merge of stacked per-process tables (concatenated in process
    order)."""
    uniq_c = np.concatenate(uniq_all, axis=0)
    counts_c = np.concatenate(counts_all)
    first_c = np.concatenate(first_all)
    w = uniq_c.shape[1]
    if w == 1:
        key = uniq_c[:, 0].astype(np.uint64)
    elif w == 2:
        key = (uniq_c[:, 0].astype(np.uint64) << np.uint64(32)) | \
            uniq_c[:, 1].astype(np.uint64)
    else:
        key = None
    if key is not None:
        order = np.argsort(key, kind="stable")
        sk = key[order]
        new = np.empty(len(sk), bool)
        new[:1] = True
        np.not_equal(sk[1:], sk[:-1], out=new[1:])
    else:
        order = np.lexsort(tuple(uniq_c[:, w - 1 - i] for i in range(w)))
        s = uniq_c[order]
        new = np.empty(len(s), bool)
        new[:1] = True
        new[1:] = (s[1:] != s[:-1]).any(axis=1)
    gid = np.cumsum(new) - 1
    n_groups = int(gid[-1]) + 1 if len(gid) else 0
    counts_g = np.zeros(n_groups, np.int64)
    np.add.at(counts_g, gid, counts_c[order])
    first_g = np.full(n_groups, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(first_g, gid, first_c[order])
    return uniq_c[order[new]], counts_g, first_g


def _engine_codes():
    """Wire codes of the engine broadcast, derived from the router's
    registry (sorted names -> dense ints), so that registering an engine
    can never desynchronise the broadcast; every process runs the same
    code, so the sort order is the contract."""
    from .._backend import _NEIGHBOR_ENGINES

    names = sorted(_NEIGHBOR_ENGINES)
    return ({n: i for i, n in enumerate(names)},
            {i: n for i, n in enumerate(names)})


def broadcast_engine_choice(*, device=None, all_gather=None,
                            process_id: int | None = None) -> str:
    """Process 0's neighbour engine, agreed by every process.

    Each engine partitions the sharded candidate work by its own rule
    (hashed runs, striped tile pairs), so every process must run the same
    one; each process's calibration (on its own card, or several
    processes measuring one card under contention) may pick another.  One
    tiny gather carries process 0's pick (``pick_neighbor_engine`` among
    the engines that honour a shard) to everyone.  The other processes
    send -1 and never ask their router, so a missing calibration is
    measured once, by process 0, not by every process on a shared card."""
    from .._backend import pick_neighbor_engine
    from .._device import resolve_device

    if all_gather is None:
        all_gather = default_all_gather
    if process_id is None:
        process_id = process_index()
    codes_by_name, names_by_code = _engine_codes()
    mine = -1
    if process_id == 0:
        mine = codes_by_name[pick_neighbor_engine(resolve_device(device),
                                                  shardable_only=True)]
    (codes,) = all_gather([np.asarray([mine], np.int64)])
    return names_by_code[int(np.asarray(codes[0]).ravel()[0])]


def merge_edge_lists(pa, pb, *, all_gather=None):
    """Gather every process's partial neighbour pairs into the global
    edge list: a pair found under several pigeonhole partitions can come
    from several processes, so the concatenation is deduplicated and
    (a, b)-sorted, equal to the unsharded pair list."""
    from ..ops.neighbors import _dedupe_pairs

    if all_gather is None:
        all_gather = default_all_gather
    pa_all, pb_all = all_gather([np.asarray(pa, np.int64),
                                 np.asarray(pb, np.int64)])
    a = np.concatenate([np.asarray(x, np.int64) for x in pa_all])
    b = np.concatenate([np.asarray(x, np.int64) for x in pb_all])
    if not len(a):
        return a, b
    return _dedupe_pairs(a, b)


def process_device(device, process_id: int):
    """The device of process ``process_id``: card ``process_id % cards``
    for a bare ``cuda`` (resolved as ``_device.resolve_device`` does),
    else the device asked for."""
    import torch

    from .._device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    return dev


def destroy() -> None:
    """Leave the process group (the CLI's last step)."""
    global _STORE
    if _initialized():
        _dist().destroy_process_group()
    _STORE = None
    _BARRIER_CALLS.clear()


__all__ = ["TIMEOUT_S", "broadcast_engine_choice", "combine_unique_tables",
           "coordination_barrier", "default_all_gather", "default_barrier",
           "destroy", "global_unique_index", "host_record_range",
           "init_distributed", "merge_edge_lists", "merge_unique_tables",
           "process_count", "process_device", "process_index"]
