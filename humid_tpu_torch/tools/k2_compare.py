"""Time the ring step K2 beside an earlier build of it, in turns, on one
card, at ring_1M_d4 (the 1M-read sample table on 4 shards, the ring's
main-path shape): one off-diagonal step and the ring's ten launches.

    python -m humid_tpu_torch.tools.k2_compare --popc-src DIR
        [--parent-tree TREE] [--rounds 4] [--reps 10] [--json FILE]

``DIR`` holds the bit-plane POPC form of K2 (the ``ring_sweep.cu`` and
``hamming_common.cuh`` of the commit before the tensor-core form, e.g.
unpacked with ``git show <commit>:humid_tpu_torch/csrc/<file>`` into a
git-ignored directory); it is built there with ``nvcc`` and bound by its
own C entry (packed blocks, no encoded tables).  Both kernels' keys must
equal the plain version's, for the one step and for the ten launches;
then, in ``--rounds`` rounds that alternate the order (current, POPC,
POPC, current, ...), each kernel alone (its launches into a buffer
allocated beforehand, between CUDA events, as ``chip_smoke.py`` phase 8
times them: the current K2 over blocks encoded beforehand) and with
max_dist -1 (no pair passes), and for the current K2 also the encoder on
one block, the ten launches each after the encode the ring makes before
it (``ring_encoded_ms``: the own block at step 0, the received one
later) and the one step through its wrapper (both blocks encoded, the
launch, the read-back and the sort).  With ``--parent-tree TREE``, a
directory holding the earlier commit's whole ``humid_tpu_torch/``
package (e.g. ``git archive <commit> humid_tpu_torch`` unpacked into a
git-ignored directory), each round also times the whole ring call
(``sharded_neighbor_pairs_ring`` on 4 shards of the card, host merge
included, wall clock) of this package (``ring_call_ms``) and of TREE's,
loaded beside it under another name (``popc_ring_call_ms``; it builds
its kernels under TREE), their pairs equal.  Then, once each after a
warm-up, the same step and the ten launches by the plain version and by
the one-hot matrix-product route (``ops/hamming.py::hamming_block_mxu``,
the reference's ``impl="mxu"``: bf16 products on a card; the lower
block of each step as its rows, since the route keeps column > row), the
route's pairs equal to K2's.  Prints one JSON line with the
simplex bound (``k1_compare.tensor_core_bound``) and each kernel's share
of it, and the card's nvidia-smi line; with ``--json`` the line is also
written to FILE.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from .k1_compare import HBM_BYTES_PER_S, tensor_core_bound, time_cuda

#: The ring's shape: reads of the sample table, shards.
READS, SHARDS = 1_000_000, 4


def build_popc(src: Path, out_dir: Path):
    """Build the POPC form's ``ring_sweep.cu`` from ``src`` into
    ``out_dir`` and bind its C entry (rows, cols, b, w, row_base,
    col_base, u, max_dist, upper_only, out_keys, cap, counter, stream)."""
    from .. import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libring_sweep_popc.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(src / "ring_sweep.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).humid_ring_sweep
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, p, i64, i32, i64, i64, i64, i32, i32, p, i64, p, p]
    fn.restype = ctypes.c_int
    return fn


def load_parent_ring(tree: Path):
    """The ``parallel.cuda_ring`` module of the ``humid_tpu_torch``
    package under ``tree``, imported as package
    ``humid_tpu_torch_parent`` (its imports are relative, so it runs its
    own modules and builds its own kernels)."""
    name = "humid_tpu_torch_parent"
    init = tree / "humid_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{name}.parallel.cuda_ring")


def wall_ms(fn, reps: int) -> float:
    """Mean wall milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, the card synchronised before and after."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def compare(popc, rounds: int, reps: int, parent_ring=None) -> dict:
    """Both kernels at ring_1M_d4 (module docstring); ``parent_ring`` is
    :func:`load_parent_ring`'s module, or None."""
    import torch

    from ..ops import hamming as H
    from ..ops import simplex_encode as SE
    from ..parallel import cuda_ring as R
    from ..parallel.mesh import data_mesh, pad_to_shards
    from .ring_profile import sample_table

    dev = torch.device("cuda")
    uniq = sample_table(READS, seed=READS % 997)
    u, w = uniq.shape
    d = SHARDS
    b = -(-u // d)
    lanes = torch.from_numpy(np.ascontiguousarray(
        pad_to_shards(uniq, d, multiple=1), np.uint32).view(np.int32)).to(dev)
    blocks = [lanes[i * b:(i + 1) * b] for i in range(d)]
    tables = [SE.encode(blk) for blk in blocks]
    steps = [(me, q, up) for me, s, q, up, emits in R.ring_schedule(d)
             if emits]
    ring_kw = [dict(row_base=me * b, col_base=q * b, u=u, upper_only=up)
               for me, q, up in steps]
    # The off-diagonal step timed alone: shard 0 against block 1.
    one = steps.index((0, 1, False))

    want = [R.ring_block_pairs_plain(blocks[me], blocks[q], max_dist=1,
                                     **ring_kw[i])
            for i, (me, q, _) in enumerate(steps)]
    want_keys = torch.sort(torch.cat([a * u + bb for a, bb in want])).values
    step_keys = want[one][0] * u + want[one][1]
    n_ring, n_step = len(want_keys), len(step_keys)
    keys = torch.empty(max(n_ring, 1), dtype=torch.int64, device=dev)
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    work = torch.zeros(len(steps), dtype=torch.int64, device=dev)
    buf = R._PairBuffer(keys, counter)
    stream = torch.cuda.current_stream().cuda_stream

    def current(which, max_dist):
        def run():
            counter.zero_()
            work.zero_()
            for i in which:
                me, q, _ = steps[i]
                R._step(blocks[me], blocks[q], buf, max_dist=max_dist,
                        tables=(tables[me], tables[q]), work=work[i],
                        **ring_kw[i])
        return run

    def popc_form(which, max_dist):
        def run():
            counter.zero_()
            for i in which:
                me, q, _ = steps[i]
                kw = ring_kw[i]
                err = popc(blocks[me].data_ptr(), blocks[q].data_ptr(), b, w,
                           kw["row_base"], kw["col_base"], u, max_dist,
                           int(kw["upper_only"]), keys.data_ptr(), len(keys),
                           counter.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"POPC K2 launch failed: {err}")
        return run

    # The ring's encodes before its launches (_Shard.step_args): the own
    # block at step 0, the received block into one buffer later.
    own = [torch.empty_like(t) for t in tables]
    received = [torch.empty_like(t) for t in tables]

    def current_encoded(which, max_dist):
        def run():
            counter.zero_()
            work.zero_()
            for i in which:
                me, q, _ = steps[i]
                if me == q:
                    SE.encode(blocks[me], out=own[me])
                    pair = (own[me], own[me])
                else:
                    SE.encode(blocks[q], out=received[me])
                    pair = (tables[me], received[me])
                R._step(blocks[me], blocks[q], buf, max_dist=max_dist,
                        tables=pair, work=work[i], **ring_kw[i])
        return run

    ring, step = range(len(steps)), [one]
    for name, fn in (("current", current), ("current_encoded",
                                             current_encoded),
                     ("popc", popc_form)):
        for which, want_k in ((ring, want_keys), (step, step_keys)):
            fn(which, 1)()
            torch.cuda.synchronize()
            n = int(counter.item())
            got = torch.sort(keys[:n]).values
            if n != len(want_k) or not torch.equal(got, want_k):
                raise AssertionError(f"the {name} K2 differs from the plain "
                                     f"version ({n} pairs, {len(want_k)})")
    wrapper_kw = dict(max_dist=1, **ring_kw[one])
    times = {k: [] for k in (
        "step_ms", "step_no_hit_ms", "ring_ms", "ring_no_hit_ms",
        "ring_encoded_ms", "encode_ms", "step_wrapper_ms", "popc_step_ms",
        "popc_step_no_hit_ms", "popc_ring_ms", "popc_ring_no_hit_ms")}
    calls = {}
    if parent_ring is not None:
        mesh = data_mesh(d, "cuda")
        calls = {"ring_call_ms": R.sharded_neighbor_pairs_ring,
                 "popc_ring_call_ms": parent_ring.sharded_neighbor_pairs_ring}
        got = {k: f(uniq, 1, word_length=24, mesh=mesh)
               for k, f in calls.items()}
        for k, (a, bb) in got.items():
            if not torch.equal(torch.from_numpy(a * u + bb).to(dev),
                               want_keys):
                raise AssertionError(f"{k}: the whole ring's pairs differ "
                                     f"from the plain version's")
        times.update({k: [] for k in calls})
    for r in range(rounds):
        order = ("current", "popc") if r % 2 == 0 else ("popc", "current")
        for which in order:
            fn, pre = ((current, "") if which == "current"
                       else (popc_form, "popc_"))
            times[f"{pre}step_ms"].append(time_cuda(fn(step, 1), 2 * reps))
            times[f"{pre}step_no_hit_ms"].append(
                time_cuda(fn(step, -1), 2 * reps))
            times[f"{pre}ring_ms"].append(time_cuda(fn(ring, 1), reps))
            times[f"{pre}ring_no_hit_ms"].append(
                time_cuda(fn(ring, -1), reps))
            if which == "current":
                times["ring_encoded_ms"].append(
                    time_cuda(current_encoded(ring, 1), reps))
                times["encode_ms"].append(time_cuda(
                    lambda: SE.encode(blocks[1], out=received[0]), 2 * reps))
                times["step_wrapper_ms"].append(time_cuda(
                    lambda: R.ring_block_pairs(blocks[0], blocks[1],
                                               **wrapper_kw),
                    max(reps // 2, 1)))
            call = f"{pre}ring_call_ms"
            if call in calls:
                times[call].append(wall_ms(
                    lambda: calls[call](uniq, 1, word_length=24, mesh=mesh),
                    max(reps // 2, 1)))
    valid = [max(0, min(u - i * b, b)) for i in range(d)]

    def plain(which):
        return lambda: [R.ring_block_pairs_plain(
            blocks[steps[i][0]], blocks[steps[i][1]], max_dist=1,
            **ring_kw[i]) for i in which]

    def onehot(which):
        def run():
            out = []
            for i in which:
                lo, hi = sorted(steps[i][:2])
                out.append(H.hamming_block_mxu(
                    blocks[lo][:valid[lo]], blocks[hi][:valid[hi]], lo * b,
                    hi * b, 1, n_ring + 1, 24)[2])
            return out
        return run

    for which, n_want in ((ring, n_ring), (step, n_step)):
        found = sum(int(c) for c in onehot(which)())
        if found != n_want:
            raise AssertionError(f"the one-hot route found {found} pairs, "
                                 f"K2 {n_want}")
    times.update(step_plain_ms=time_cuda(plain(step), 1),
                 ring_plain_ms=time_cuda(plain(ring), 1),
                 step_onehot_ms=time_cuda(onehot(step), 3),
                 ring_onehot_ms=time_cuda(onehot(ring), 1))
    evaluations = [valid[me] * (valid[me] - 1) // 2 if up
                   else valid[me] * valid[q] for me, q, up in steps]
    enc_bytes = tables[0].numel()
    step_bound = tensor_core_bound(evaluations[one], w,
                                   2 * enc_bytes + 8 * n_step, 3)
    ring_bound = tensor_core_bound(sum(evaluations), w,
                                   len(steps) * 2 * enc_bytes + 8 * n_ring, 3)
    best = {k: min(v) if isinstance(v, list) else v
            for k, v in times.items()}
    out = {"shape": "ring_1M_d4", "uniques": u, "shards": d,
           "block_rows": b, "w": w, "launches": len(steps),
           "step_pairs": n_step, "ring_pairs": n_ring,
           "step_evaluations": evaluations[one],
           "ring_evaluations": sum(evaluations), "max_abs_err": 0,
           "rounds": rounds, "reps": reps, **times,
           "form": "int8_simplex",
           "step_bound_ms": step_bound["bound_ms"],
           "ring_bound_ms": ring_bound["bound_ms"],
           "step_bound_share": step_bound["bound_ms"] / best["step_ms"],
           "ring_bound_share": ring_bound["bound_ms"] / best["ring_ms"],
           "popc_ring_bound_share": ring_bound["bound_ms"]
           / best["popc_ring_ms"],
           "slot_bytes": b * w * 4, "encoded_bytes": enc_bytes,
           "encode_bound_ms": (b * w * 4 + enc_bytes) / HBM_BYTES_PER_S
           * 1e3,
           "step_current_over_popc": best["step_ms"] / best["popc_step_ms"],
           "ring_current_over_popc": best["ring_ms"] / best["popc_ring_ms"],
           "ring_encoded_over_popc": best["ring_encoded_ms"]
           / best["popc_ring_ms"]}
    if calls:
        out["ring_call_current_over_popc"] = (best["ring_call_ms"]
                                              / best["popc_ring_call_ms"])
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--popc-src", type=Path, required=True)
    ap.add_argument("--parent-tree", type=Path)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k2_compare needs a CUDA card", file=sys.stderr)
        return 1
    from .. import _build

    popc = build_popc(args.popc_src.resolve(),
                      _build.BUILD_DIR / "k2_compare")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    parent_ring = (None if args.parent_tree is None
                   else load_parent_ring(args.parent_tree.resolve()))
    line = compare(popc, args.rounds, args.reps, parent_ring)
    print(smi, flush=True)
    if args.json:
        args.json.write_text(json.dumps({**line, "card": smi}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
