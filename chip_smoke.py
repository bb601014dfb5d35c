#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (humid_tpu_torch) runs on an
NVIDIA GPU.  Run from the root of a checkout, on a machine with one CUDA
card and nvcc:

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:

1. CUDA is present; the card's name and power limit (nvidia-smi).
2. The three kernels (humid_tpu_torch/csrc/hamming_sweep.cu,
   ring_sweep.cu, both on the pipeline of tc_sweep.cuh, and their
   encoder simplex_encode.cu) are built from source with nvcc, one
   process each, started together (seconds; ptxas reports printed).  The
   disassembly of both Hamming kernels must show, at w = 2 and w = 3 (and
   in K1's 128-column instance for short lists at w = 2), the products on
   the int8 warpgroup MMA (``IGMMA...S8.S8``, one per k-step of the
   encoded word) and no POPC loop (``tc_products``).
3. Kernel vs its plain PyTorch version on the card, on sweep inputs built
   exactly as the neighbour engines build them: the bucketed table of a
   1M-read sample (~2e5 uniques) and of a 10M-read sample (~2e6
   uniques), both w = 2, tile 2048, m = 1; the dense engine's input of
   the same 1M-read table (``dense_1M``, every tile pair: the shape the
   main path gives K1, since the router picks ``dense`` at this size);
   and a dense table of ~1.6e4 uniques, L = 33 (w = 3), m = 2, with
   partition padding.  The (a, b) pair arrays must be identical (integer work: no
   tolerance).  Four times per shape, CUDA-event means after a warm-up:
   ``kernel_ms``, the kernel alone (the launches of one call into a
   buffer allocated beforehand, nothing else between the events);
   ``no_hit_kernel_ms``, the same with max_dist -1, where no pair passes;
   ``ms``, the wrapper ``hamming_tile_pairs`` (allocation, launch, the
   one read-back, the sort, and the encoded table the wrapper builds);
   ``plain_ms``, the plain version.  Beside them the bound of the form
   the kernel runs, the simplex int8 tensor-core form (3 x 16 w
   multiply-adds a pair: ``bound_ms``, ``form``), and the kernel's share
   of it, and the card's ``roofline_ms``: the least of the POPC, one-hot
   and simplex forms' bounds (``roofline``); a kernel time below either
   fails the phase.  Phase 6 prints both for its shape too, phase 8 the
   ring's (K2 runs the same form).
4. End to end: a 1M-read sample made by the benchmark recipe (single-end
   100 bp, dup factor 8, 30% one-substitution reads;
   ``humid_tpu_torch.tools.bench.gen_dataset``, bench.py's recipe), run
   with ``-n 24 -m 1 -s -a`` on the card in process through
   ``humid_tpu_torch.run`` by the default route, the one the router's
   parameters of phase 13 choose (kernel launch counts reset
   just before, read just after; the engine that ran must be the
   router's pick at the run's size, and on this path it must have
   launched the tile sweep: the dense K1 sweep is the pick at this
   table's size) and once more through ``python -m humid_tpu_torch``
   in a subprocess; both must write identical files, dedup lines == 4 x
   clusters and annotated lines == 4 x total.  If g++ and zlib are
   present, baseline/humid_ref is built and its outputs must be
   byte-identical.
5. Ring kernel vs its plain version, one step, on the card (tolerance
   0): b = 16,384, w = 2, m = 1 with ``upper_only`` true and false and
   ``u`` cutting the column block in the middle; w = 3, m = 2 both ways;
   and w = 3 with max_dist >= 16 w, where every valid pair matches.  Two
   launches give identical sorted arrays.
6. The tile sweep with a run-id mask vs its plain version, on one shard's
   input of the bucketed mesh search built from the 1M-read table; the
   kernel alone, the wrapper with and without ids, the plain version and
   the bound.
7. The whole ring on a 65,536-unique table (w = 2, m = 1) for 1, 2, 3, 4
   and 8 shards on the one card, twice each: every result must equal the
   plain ring at 3 shards (the schedule driven through the plain step)
   and the dense tile sweep.  1 and 4 shards are timed.
8. The ring at the main path's size: the 1M-read table on 4 shards must
   equal the bucketed tile sweep; kernel time (CUDA events around the
   schedule's launches over blocks encoded beforehand; and with no pair
   passing), launches, encodes and pair evaluations/s are printed, and
   for one step the kernel alone (and with no pair passing), the wrapper
   and the plain version, each beside the simplex bound; the encoder on
   each block equals ``encode_table`` byte for byte, and its time for one
   block (CUDA events, and the kernel's own from ``torch.profiler``),
   the plain version's, its bytes' bound, and the bytes of a comm slot
   and of an encoded block.
9. End to end through the mesh: the phase-4 file with
   ``neighbor_opts={"strategy": "ring"}`` on 4 shards (ring launch count
   reset before, >= 1 required after), with ``"sharded_bucketed"`` (tile
   sweep launches >= 1), and through ``python -m humid_tpu_torch`` with
   HUMID_TPU_TORCH_STRATEGY=ring HUMID_TPU_TORCH_SHARDS=4; all outputs
   byte-identical to phase 4's and to baseline/humid_ref.
10. Edit distance, the DP on the card against the CPU (tolerance 0):
    ``_banded_levenshtein`` (one 512 x 512 tile, and batched),
    ``_banded_levenshtein_pairs`` and ``edit_block`` on the card equal
    the same functions on the CPU, and a scalar Levenshtein written here,
    at L = 18, 24, 33 and m = 1, 2, 3.
11. Edit distance, the engines on the card: on 8,192 uniques of L = 33
    (m = 2) and on 65,536 of L = 24 (m = 1), tables with shifted copies
    of a quarter of their words (``with_indels``), the dense scan, the
    shifted-segment search (``runs``), ``sharded`` on 1, 2 and 4 shards,
    the shifted mesh search and the dense edit ring give the same pair
    arrays.  Wall times of each.  Then the three edit programs at the shapes PERF.md
    records: the dense tile scan at the 8,192-unique table, one step of
    the dense edit ring at the block 4 shards give that table, and
    ``edit_pairs_verify`` on the candidates of the 1M-read table; for each
    the time by CUDA events, the kernels it launched (``torch.profiler``)
    and two bounds (the DP's integer operations over the card's rate; the
    bytes its elementwise operations write and read back over the memory
    rate).
12. ``-e`` end to end: the phase-4 file with ``-n 24 -m 1 -e -s -a``
    through ``humid_tpu_torch.run`` on the card by the default route
    (which must take the shifted-segment search), by ``sharded`` on 4
    shards and through ``python -m humid_tpu_torch -e``; all outputs
    byte-identical to ``baseline/humid_ref -e``; phase seconds, and the
    neighbour phase's parts (joins, dedupe, verify) timed on their own.
    At m = 1 words of one length are within edit distance 1 exactly when
    within Hamming distance 1, so that run's clusters are phase 4's.  So
    also a run where the metrics differ: phase 11's 8,192 words of L = 33
    with shifted copies, written as 24,576 reads, with ``-n 33 -m 2 -s
    -a`` and with ``-e`` added; each byte-identical to
    ``baseline/humid_ref`` with the same flags, and ``-e`` must leave
    fewer clusters.
13. The router's calibration (run before phase 4): ``engine_constants``
    measured once into build/chip_smoke/engine_calib.json
    (HUMID_TPU_TORCH_CALIB_PATH, which every later run and CLI subprocess
    reads) at its two probes; each engine's time at both, the two
    parameters fitted to them, the seconds the calibration took, and the
    choices they make at the sweep tables' sizes are printed.
14. The Hamming engines against each other at sweep_1M and sweep_10M's
    tables: host ``runs``, ``runs_device``, ``bucketed``, ``dense`` and,
    with several cards, the bucketed mesh search give identical pair
    arrays; wall times (best of 2) beside the router's pick and its
    predictions at each table's size: the pick may be slower than the
    fastest engine by no more than the calibration's spread + 10%;
    ``fused_probe`` on
    1M and 10M packed reads of the benchmark recipe equals host
    ``unique_words`` + ``runs``; a feeder that starts short grows and
    holds every row of 10M.
15. The device programs at e2e_1M's shape, on the inputs a fused run
    gives them: programs A (unique counting), B (partitions), C (the base
    sweeps, with match masks), D (-x labels), ``_runs_eval`` at the device
    runs engine's depth and ``unique_words_device`` whole; for each the
    kernels launched (``torch.profiler``), ms by CUDA events and the bound
    of ``program_bound`` (bytes over the memory rate, integer operations
    over the card's rate); for unique counting also ``torch.unique``.
16. Every route end to end on the phase-4 file: forced fused
    (HUMID_TPU_TORCH_FUSED=1; fails if it fell back), host ``runs``,
    ``runs_device``, ``bucketed`` (at least one tile sweep launch) and
    ``-x`` through the fused device labels, each byte-identical to
    baseline/humid_ref with its flags; then a low-entropy file of 400,000
    reads (5,000 pool sequences share 12 bases: one run of some 6,000
    rows) by the default route, host ``runs`` and forced fused, each of
    which must launch the tile sweep for its big run (``_big_run_pairs``)
    and write humid_ref's bytes.  Phase seconds per route are printed.
17. mp_1M: the phase-4 file through the CLI as 4 processes of one gloo
    group on the card (a free localhost port), with
    HUMID_TPU_TORCH_CLUSTER_SHARDED=1; the neighbour search must run on
    the card (the broadcast pick, else HUMID_TPU_TORCH_DEVICE_ENGINE=1
    forces a device engine).  Each process's launch counts (read just
    after its run; a process starts at 0), search record and the scaling
    report are printed; outputs byte-identical to phase 4's and to
    baseline/humid_ref.
18. mp_big_runs: phase 16's low-entropy file as 4 processes, the cluster
    gate at its default (replicated): byte-identical to phase 16's
    default run, and at least one K1 launch summed over the processes
    (the owned giant run through ``_big_run_pairs``).
19. mp_edit and mp_gz: a 200,000-read file of the same recipe with ``-e``
    as 2 processes, and its gzip copy as 3 processes (the range spill);
    each against the single-process port (in process) and
    baseline/humid_ref with the same flags (gzip by decompressed bytes).
20. mesh_labels: e2e_1M's unique table (179,207 words) and its bucketed
    K1 pairs; ``distributed_components`` replicated (the default) and
    node-sharded on 4 shards of the card, and ``dedup_step`` on 4 shards
    (K2 launches counted, >= 1), label for label against the single-card
    ``connected_components_device``; ms by CUDA events, kernels and busy
    time (the union of the kernels' intervals) from ``torch.profiler``,
    and ``program_bound``.  Run right after phase 4: later in the
    process the trace loses K2 events, and then no busy time is kept.
21. startup: one subprocess timing the torch import, the package import,
    CUDA init, ``_build.py``'s staleness check and the calibration cache
    read.
22. directional_1M: e2e_1M's unique table and its bucketed K1 pairs
    (K1 launches counted) through ``cluster_directional_device`` on the
    card, equal field for field to the host walk and to the same function
    on the CPU; the round program's ms by CUDA events, its rounds,
    kernels and busy time (``torch.profiler``) and ``program_bound``; a
    40-node doubling chain on the card against the host walk; the phase-4
    file with HUMID_TPU_TORCH_CLUSTER=device, byte-identical to
    baseline/humid_ref, its "Calculating directional clusters" seconds
    beside phase 4's.
23. The phase-4 file with ``profile_dir=``: one Chrome trace that parses
    and holds CUDA kernel events (counted) and the three phase ranges,
    outputs equal to phase 4's.
24. Host extensions built: humid_tpu_torch/, csrc/ and setup.py copied to
    build/chip_smoke/ext_tree/ and ``setup.py build_ext --inplace`` run
    there by the first compiler pair that links -fopenmp
    (``check_native.openmp_toolchain``, passed as CC and CXX; the line
    says ``openmp: true``, or why no pair could and the copy is built
    without it); the phase-4 file by two subprocesses from that copy
    (their own calibration file): the default route and
    HUMID_TPU_TORCH_CLUSTER=device, each byte-identical to
    baseline/humid_ref; phase seconds printed.  Without a compiler or
    Python headers the phase says so on its own line and the run goes
    on.
25. The bucketed mesh search on 4 shards over every card (one card: the
    4 shards round-robin on it, and a line says that no overlap can be
    shown there), every shard enqueued before any read, at sweep_1M and
    sweep_10M against phase 14's ``runs`` pairs: wall ms, the host prep's
    share, K1 launches per card, and with several cards the cards' K1
    intervals on one clock and the pairs of cards whose kernels
    overlapped (``--mesh`` fails, after its other checks, unless two
    cards' kernels overlapped at sweep_10M).
26. One JSON line describing the kernels: ``launches`` on this slice's
    path (phase 32's e2e_1M runs: HUMID_TPU_TORCH_IMPL=pallas for the tile
    sweep, ``strategy="sharded", impl="pallas_ring"`` for the ring), each
    earlier path's in ``launches_by_path``;
    ``ms``, the kernel alone (phase 3's ``kernel_ms`` at ``dense_1M``,
    the main path's shape, for the tile sweep; phase 8's one step for the
    ring);
    ``wrapper_ms``, the same call through its wrapper; ``plain_ms``; the
    bound of the form each kernel runs for the same work (``form``: the
    simplex int8 tensor-core form, both) and the card's roofline
    (``roofline_ms``, ``roofline_by``, ``roofline_form``); ``library_ms``,
    ``library_form`` and ``library_matmul_ms``: the same function by the
    one-hot matrix-product route (the reference's ``impl="mxu"``, bf16
    products as the port takes it on a card; phase 32, at dense_1M and at
    the ring's one step); the ring's ten launches (``ring_ms``,
    ``ring_bound_ms``).  A third entry, the encoder (phase 8's block;
    ``launches`` on the ring's run of phase 32, one a K2 launch; its
    bytes' bound; ``library_ms`` null: no one PyTorch call encodes).  The
    edit path launches none of them and adds none.  ``sanitizer``: phase 31's
    result for the kernel.  Then the card's nvidia-smi line and the
    result line ``{"ok": true, "device": {...}}``.  Every phase's seconds
    are printed after it ("phase N seconds").
27. bench_1M (run before phase 26's line): ``python -m
    humid_tpu_torch.tools.bench`` (1,000,000 reads, distance 1: bench.py's
    flags) as a subprocess from phase 24's extension tree and from the
    checkout (numpy fallbacks), one dataset cache for both; each JSON
    line (printed as it is, beside the card's nvidia-smi line) must say
    backend cuda, carry the card, list the tree's host extensions and a
    measured humid_ref baseline, and the bench's dedup file must equal
    humid_ref's from the same run.  Without phase 24's tree only the
    checkout runs, said on its own line.  Then the bench's dataset once
    in process through ``run()`` with the bench's flags: its K1 launches
    (``launches_by_path["bench_1M"]``; the ``dense`` pick must launch K1)
    and its traced kernels.

28. fuzz_oracle (run after phase 27): ``python -m
    humid_tpu_torch.tools.fuzz_oracle 100 10000 --shards 8`` on the card
    with phase 13's calibration file: 100 configs of the JAX package's
    wide fuzz draw (every engine forced, degenerate pools, the fused
    route, device directional clustering, ``-e``) against the string
    oracle; K1 and K2 must both have launched in the campaign (the
    kernels line's ``launches``: the tool's process starts at 0).
29. fuzz_multiproc: ``python -m humid_tpu_torch.tools.fuzz_multiproc 4
    42000``: 4 random configs as 2-3 CLI processes of one gloo group on
    the card, byte-identical to the in-process run; seconds per config.
30. engine_xover (run after phase 31's host half has ended, so that no
    compile shares the host with its timings): ``engine_xover.measure``
    in process at 2^18, 2^20, 2^22 and 2^23 uniques, all six engines,
    best of 2; every engine's pairs equal (tolerance 0); the router's
    pick and predictions beside the fastest engine, and its fused
    decision beside the two whole-pipeline engines.  A pick slower than
    the fastest by more than the spread + 10% is printed as a FAULT line
    and does not fail the phase (a measurement, not a check).
31. check_native: the host half (``--host``: the extensions rebuilt with
    AddressSanitizer in build/check_native/tree/, the jax-free native
    tests and 20 fuzz configs under it) runs in the background from
    phase 28 on; without a compiler, Python headers or a compiler with
    libasan it says so on its own line.  The device half (``--device``,
    after phase 30): K1 and K2's small edge-case shapes under
    compute-sanitizer's memcheck, racecheck, initcheck and synccheck,
    then with guard rows and sentinel words on the card.  Any error found
    fails the phase.  Where the tool cannot attach to the card, a line
    says "NOT SHOWN": zero errors under those tools is not shown, and
    only the guard checks ran (K1's through an encoded table whose rows
    past N are poisoned guard rows).  Then the stand-in for racecheck:
    every case launched 20 times with the first capacity forced to 16
    pairs (each call overflows and relaunches), each result bit for bit
    equal to the first and to the plain version; K1 also at a busy shape
    where every persistent CTA's rings of stages and panels wrap.  The
    kernels line gives each kernel's ``sanitizer`` statuses,
    ``zero_errors_shown``, guarded cases and repeat cases.
32. The ``impl=`` choice: the one-hot matrix-product route
    (``ops/hamming.py::onehot_tile_pairs``, bf16 products) against K1 and
    the plain version at dense_1M and sweep_1M, against K1 at sweep_10M,
    dense_L33_m2 and ids_shard0 (the route whole only), and
    ``hamming_block_mxu``
    against K2 and its plain version at ring_1M_d4's one step (tolerance
    0); the route whole (CUDA-event means after a warm-up, and its device
    busy time from ``torch.profiler``) and its products alone, in bf16 and
    again as int8 ``torch._int_mm`` for comparison.  Then e2e_1M through
    ``run()`` with HUMID_TPU_TORCH_IMPL=pallas (K1 must launch),
    ``neighbor_opts={"impl": "mxu"}`` (no K1) and ``{"strategy":
    "sharded", "impl": "pallas_ring"}`` on 4 shards (K2 must launch), each
    byte-identical to baseline/humid_ref and recording its impl.
33. The two opt-in host routes on phase 24's tree: the overlapped pass 1
    + unique route (HUMID_TPU_TORCH_OVERLAP_UNIQUE=1) and the
    component-parallel walk (HUMID_TPU_TORCH_CLUSTER=parallel), each
    alone, then the default, three rounds, in one subprocess each for
    e2e_1M (phase 4's flags) and bench_1M (bench.py's); each route must
    engage, and every output equals baseline/humid_ref's; best of 3 of
    the read + unique seconds and the clustering seconds beside the
    default's.

``python3 chip_smoke.py --mesh`` (for a machine with several cards)
runs only the mesh route and what it is held against: phases 13 and 14,
the ring, both edit mesh searches and ``dedup_step`` on one shard a card
against the same four shards on card 0, e2e_1M by ``auto`` (phase 4)
against baseline/humid_ref, and phase 25; it ends with every card's
nvidia-smi line and the result line.

Scratch files go to build/chip_smoke/ inside the checkout.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
sys.path.insert(0, REPO)
# The timing loop and the tile sweep's pair count, shared with the tool
# that times K1 beside an earlier build of it.
from humid_tpu_torch.tools.k1_compare import (  # noqa: E402
    sweep_evaluations, time_cuda)


class SmokeFailure(Exception):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def tc_products(sass: str, kernel: str) -> dict:
    """The tensor-core products in the w = 2 and w = 3 instances of
    ``kernel`` (either Hamming kernel), from its disassembly: the IGMMA
    instructions (the int8 warpgroup MMA), their mnemonics, and the
    k-steps one product of an encoded word takes (``table_width(w) /
    32``); also the POPC count and ``other_POPC``, the POPC that are not
    a lane's rank in a warp vote (``POPC(SR_LTMASK & mask)``: the
    compiler's warp-aggregated atomics, which the hit buffer's adds
    compile to, once for each copy of the epilogue's walk).  A distance
    loop of the POPC form counts the bits of XORed words, so any POPC of
    it is an ``other_POPC``."""
    import re

    from humid_tpu_torch.ops.cuda_hamming import table_width

    instr = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d\s+)?"
                       r"([A-Z0-9_.x]+)\s*([^;]*);")

    def writer(code, i, reg):
        """The instruction before i (16 at most) that last wrote reg."""
        for j in range(i - 1, max(-1, i - 17), -1):
            if code[j][1][:1] == [reg]:
                return j
        return None

    def lane_rank(code, i):
        j = writer(code, i, code[i][1][1])
        if j is None or not code[j][0].startswith("LOP3"):
            return False
        for reg in code[j][1][1:3]:
            k = writer(code, j, reg)
            if k is not None and code[k][0] == "S2R" \
                    and code[k][1][1:2] == ["SR_LTMASK"]:
                return True
        return False

    out = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0]
        w = next((w for w in (2, 3) if f"{kernel}ILi{w}EE" in name), None)
        if w is None:
            continue
        code = [(m.group(1), [a.strip() for a in m.group(2).split(",")])
                for m in instr.finditer(fn)]
        mma = [op for op, _ in code if op.startswith("IGMMA")]
        popc = [i for i, (op, _) in enumerate(code) if op == "POPC"]
        k = table_width(w)
        out[f"w{w}"] = {"igmma": len(mma), "mnemonics": sorted(set(mma)),
                        "k_steps": k // 32, "POPC": len(popc),
                        "other_POPC": sum(not lane_rank(code, i)
                                          for i in popc)}
    return out


def bound_ms(evaluations: int, w: int, n_bytes: int, card: dict) -> dict:
    """Least time the card could take for ``evaluations`` word pairs of
    ``w`` lanes in the exact-integer POPC form, the cheapest formulation
    that has been built: the largest of

    * the bytes moved over the memory rate (3.35e12 B/s, the H100 data
      sheet);
    * the POPC operations over SMs x 16 POPC/clock x the card's maximum
      SM clock.  The form needs one POPC per 32 bases, ceil(w / 2) a
      pair: with the words split into bit planes a 32-base difference
      mask is (lo_r ^ lo_c) | (hi_r ^ hi_c).  (One POPC per 16-base lane,
      w a pair, is what the lane form spends, not what the work needs.)
    * the other integer operations of that form (an XOR and a three-input
      logic operation per POPC, and an add or the final compare:
      3 ceil(w / 2) a pair), over SMs x 64/clock.

    POPC always comes out ahead of the integer operations (1/16 against
    3/64 of a clock per plane pair); both are computed so that a cheaper
    formulation of either would show.  It is this form's bound, not the
    card's (``roofline``), so a share of this bound says how well the POPC
    loop runs, not how far the card is from its limit."""
    plane_pairs = -(-w // 2)
    per_s = card["sms"] * card["sm_hz"]
    popc_ms = evaluations * plane_pairs / (16 * per_s) * 1e3
    int_ms = evaluations * 3 * plane_pairs / (64 * per_s) * 1e3
    bytes_ms = n_bytes / 3.35e12 * 1e3
    ops_ms = max(popc_ms, int_ms)
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def roofline(evaluations: int, w: int, n_bytes: int, card: dict) -> dict:
    """The card's least time for ``evaluations`` word pairs of ``w``
    lanes: the least of three formulations' bounds, each the larger of
    its bytes over the memory rate and its operations over the rate of
    the unit that does them:

    * the exact-integer POPC form, as ``bound_ms`` computes it;
    * the one-hot int8 tensor-core form (the TPU kernel's MXU matmul):
      each base a one-hot of 4, so a pair costs 4 x 16w int8
      multiply-adds, 2 operations each, at 1,979 TOP/s
      (``tools/k1_compare.py::tensor_core_bound``);
    * the simplex int8 tensor-core form (K1's: 3 channels of +-1 a base),
      3 x 16w multiply-adds a pair.

    ``roofline_form`` names the form that sets it ("popc", "int8_onehot"
    or "int8_simplex")."""
    from humid_tpu_torch.tools.k1_compare import tensor_core_bound

    forms = {"popc": bound_ms(evaluations, w, n_bytes, card),
             "int8_onehot": tensor_core_bound(evaluations, w, n_bytes, 4),
             "int8_simplex": tensor_core_bound(evaluations, w, n_bytes, 3)}
    form = min(forms, key=lambda f: forms[f]["bound_ms"])
    return {"roofline_ms": forms[form]["bound_ms"],
            "roofline_by": forms[form]["bound_by"], "roofline_form": form}


def simplex_bound(evaluations: int, w: int, n_bytes: int) -> dict:
    """The bound of the form both kernels run: the simplex int8
    tensor-core form (``roofline``), named in ``form``."""
    from humid_tpu_torch.tools.k1_compare import tensor_core_bound

    return {**tensor_core_bound(evaluations, w, n_bytes, 3),
            "form": "int8_simplex"}


def within_bound(name: str, kernel_ms: float, bound: dict,
                 key: str = "bound_ms") -> float:
    """The bound's share of the kernel's time (1.0: the kernel runs at the
    bound); ``key`` names the bound in ``bound``.  A kernel faster than its
    bound means the bound or the timing is wrong: that fails."""
    if kernel_ms < bound[key]:
        raise SmokeFailure(f"{name}: kernel {kernel_ms} ms is below its "
                           f"{key} {bound[key]} ms")
    return bound[key] / kernel_ms


def sweep_kernel_ms(lanes, tp, kw, n_pairs: int, reps: int) -> float:
    """The tile sweep's kernel alone: the launches of one call (chunked as
    the wrapper chunks, over an encoded table built beforehand) into a
    buffer allocated beforehand, between two CUDA events.  The counter
    must end at ``n_pairs``."""
    import torch

    from humid_tpu_torch.ops import cuda_hamming as K

    keys = torch.empty(max(n_pairs, 1), dtype=torch.int64,
                       device=lanes.device)
    counter = torch.zeros(2, dtype=torch.int64, device=lanes.device)
    table = K.encode_table(lanes)  # the wrapper's pre-pass, not timed

    def launches():
        counter.zero_()
        for lo in range(0, len(tp), K.CHUNK_PAIRS):
            K._launch(lanes, tp[lo:lo + K.CHUNK_PAIRS], keys, counter,
                      table=table, **kw)

    ms = time_cuda(launches, reps)
    if counter.tolist() != [n_pairs, 0]:
        raise SmokeFailure(f"the timed launches left the counter at "
                           f"{counter.tolist()}, expected [{n_pairs}, 0]")
    return ms


def k1_bytes(lanes, tp, n_pairs: int, ids=None) -> int:
    """Bytes K1 must move: its encoded table read once (rows padded to
    ``TABLE_ROWS``), the tile pairs and run ids read, the keys written."""
    from humid_tpu_torch.ops import cuda_hamming as K

    n, w = lanes.shape
    rows = max(-(-n // K.TABLE_ROWS), 1) * K.TABLE_ROWS
    return (rows * K.table_width(w) + tp.numel() * 4 + 8 * n_pairs
            + (0 if ids is None else ids.numel() * 4))


def kernel_vs_plain(name, rows, tile_pairs, *, tile, u_pad, u, max_dist,
                    device, card, reps: int = 5, plain_reps: int = 1) -> dict:
    """Run the sweep's kernel wrapper and its plain version on the same
    device tensors; require identical pair arrays; time the kernel alone,
    the wrapper and the plain version."""
    import torch

    from humid_tpu_torch.ops import cuda_hamming as K
    from humid_tpu_torch.ops.neighbors import sweep_tensors

    lanes, tp = sweep_tensors(rows, tile_pairs, device)
    kw = dict(tile=tile, part_stride=u_pad, part_valid=u, max_dist=max_dist)
    ka, kb = K.hamming_tile_pairs(lanes, tp, **kw)
    pa, pb = K.hamming_tile_pairs_plain(lanes, tp, **kw)
    if ka.shape != pa.shape:
        raise SmokeFailure(f"{name}: kernel found {len(ka)} pairs, plain "
                           f"{len(pa)}")
    err = 0
    if len(ka):
        err = int(max((ka - pa).abs().max(), (kb - pb).abs().max()))
    if err:
        raise SmokeFailure(f"{name}: kernel and plain pairs differ "
                           f"(max abs err {err})")
    again = K.hamming_tile_pairs(lanes, tp, **kw)
    if not (torch.equal(again[0], ka) and torch.equal(again[1], kb)):
        raise SmokeFailure(f"{name}: two kernel runs differ")
    kernel_ms = sweep_kernel_ms(lanes, tp, kw, len(ka), 4 * reps)
    # max_dist -1: no pair passes, the compare loop without the appends.
    no_hit_ms = sweep_kernel_ms(lanes, tp, {**kw, "max_dist": -1}, 0,
                                4 * reps)
    ms = time_cuda(lambda: K.hamming_tile_pairs(lanes, tp, **kw), reps)
    plain_ms = time_cuda(lambda: K.hamming_tile_pairs_plain(lanes, tp, **kw),
                         plain_reps)
    evaluations = sweep_evaluations(len(rows), tile_pairs, tile, u_pad, u)
    n_bytes = k1_bytes(lanes, tp, len(ka))
    bound = simplex_bound(evaluations, int(lanes.shape[1]), n_bytes)
    roof = roofline(evaluations, int(lanes.shape[1]), n_bytes, card)
    out = {"rows": int(lanes.shape[0]), "w": int(lanes.shape[1]),
           "tile_pairs": int(len(tp)), "pairs": int(len(ka)),
           "max_abs_err": err, "kernel_ms": kernel_ms,
           "no_hit_kernel_ms": no_hit_ms, "ms": ms,
           "plain_ms": plain_ms, "evaluations": evaluations, **bound,
           "bound_share": within_bound(name, kernel_ms, bound), **roof,
           "roofline_share": within_bound(name, kernel_ms, roof,
                                          "roofline_ms")}
    say(f"phase 3 {name}: kernel == plain (tolerance 0, integer pairs); "
        f"{json.dumps(out)}")
    return out


def sweep_phase(device, card) -> dict:
    from humid_tpu_torch.ops.neighbors import bucketed_inputs, dense_inputs
    from humid_tpu_torch.tools.ring_profile import sample_table

    results, tables = {}, {}
    for name, n_reads in (("bucketed_1M_reads", 1_000_000),
                          ("bucketed_10M_reads", 10_000_000)):
        uniq = tables[name] = sample_table(n_reads, seed=n_reads % 997)
        rows, tps, b, u_pad, _ = bucketed_inputs(uniq, 1, 24, 2048)
        say(f"phase 3 {name}: {len(uniq)} uniques, {len(tps)} tile pairs")
        results[name] = kernel_vs_plain(
            name, rows, tps, tile=b, u_pad=u_pad, u=len(uniq), max_dist=1,
            device=device, card=card)
    # The shape the main path gives K1: at this size ``auto`` picks the
    # dense engine (phase 13), every tile pair of the 1M-read table.
    uniq = tables["bucketed_1M_reads"]
    rows, tps, b, u_pad = dense_inputs(uniq, 2048)
    say(f"phase 3 dense_1M: {len(uniq)} uniques, {len(tps)} tile pairs")
    results["dense_1M"] = kernel_vs_plain(
        "dense_1M", rows, tps, tile=b, u_pad=u_pad, u=len(uniq), max_dist=1,
        device=device, card=card, reps=2)
    uniq = tables["dense_L33_m2"] = sample_table(72_000, 33, seed=33,
                                                      n_subst=2)
    rows, tps, b, u_pad = dense_inputs(uniq, 2048)
    say(f"phase 3 dense_L33_m2: {len(uniq)} uniques, u_pad {u_pad}")
    results["dense_L33_m2"] = kernel_vs_plain(
        "dense_L33_m2", rows, tps, tile=b, u_pad=u_pad, u=len(uniq),
        max_dist=2, device=device, card=card, reps=20, plain_reps=3)
    return results, tables


def _lines(path: str) -> int:
    with open(path, "rb") as f:
        return sum(chunk.count(b"\n") for chunk in iter(
            lambda: f.read(1 << 24), b""))


def _stats(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "stats.dat")) as f:
        return {k: int(v) for k, v in (ln.split(": ") for ln in f)}


def _same_files(d1: str, d2: str) -> None:
    n1, n2 = sorted(os.listdir(d1)), sorted(os.listdir(d2))
    if n1 != n2:
        raise SmokeFailure(f"output files differ: {n1} vs {n2}")
    for n in n1:
        if subprocess.run(["cmp", "-s", os.path.join(d1, n),
                           os.path.join(d2, n)]).returncode:
            raise SmokeFailure(f"{n} differs between {d1} and {d2}")


#: Neighbour engines that run every pair through the tile sweep K1.
K1_ENGINES = ("dense", "bucketed", "sharded_bucketed")


def check_launches(name: str, engine: dict, launches: int) -> None:
    """The launch check follows the engine that ran: an engine of K1 must
    have launched it; the runs engines and the fused route launch it only
    for runs longer than ``run_cap`` (their device work is PyTorch ops),
    and a fused run must not have fallen back to the host path."""
    if engine.get("strategy") in K1_ENGINES and launches < 1:
        raise SmokeFailure(f"{name}: engine {engine} launched no tile sweep")
    if engine.get("fused_fallback"):
        raise SmokeFailure(f"{name}: the fused route fell back: {engine}")


def end_to_end_phase(n_reads: int, device: str = "cuda") -> dict:
    import humid_tpu_torch
    from humid_tpu_torch.ops import cuda_hamming

    from humid_tpu_torch.tools.bench import gen_dataset

    fq = os.path.join(WORK, "sample.fastq")
    t0 = time.perf_counter()
    gen_dataset(fq, n_reads, seed=5)
    say(f"phase 4: generated {n_reads} reads in "
        f"{time.perf_counter() - t0:.3f} s")
    flags = ["-n", "24", "-m", "1", "-s", "-a"]
    out_run = os.path.join(WORK, "out_run")
    env = dict(os.environ, HUMID_TPU_TORCH_DEVICE=device)

    cuda_hamming.LAUNCHES = 0
    t0 = time.perf_counter()
    res = humid_tpu_torch.run([fq], word_length=24, distance=1,
                              log_name=os.path.join(WORK, "run.log"),
                              dir_name=out_run, run_stats=True,
                              write_annotated=True, device=device)
    seconds = time.perf_counter() - t0
    launches = cuda_hamming.LAUNCHES
    engine = res.extra["engine"]
    pick = default_hamming_engine(device, fq, len(res.counts))
    say(f"phase 4 run() by the default route: {seconds:.3f} s, "
        f"{len(res.counts)} uniques, engine {json.dumps(engine)} (the "
        f"router's pick: {pick}), tile sweep launches {launches}, timings "
        f"{json.dumps(res.extra['timings'])}")
    check_launches("phase 4 default route", engine, launches)
    if engine.get("strategy") != pick:
        raise SmokeFailure(f"phase 4: the default route ran {engine}, the "
                           f"router picks {pick}")

    out_cli = os.path.join(WORK, "out_cli")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "humid_tpu_torch", *flags, "-d", out_cli,
         "-l", os.path.join(WORK, "cli.log"), fq],
        cwd=REPO, env=env, capture_output=True, text=True)
    cli_seconds = time.perf_counter() - t0
    if proc.returncode:
        raise SmokeFailure(f"python -m humid_tpu_torch failed:\n"
                           f"{proc.stderr}")
    say(f"phase 4 python -m humid_tpu_torch: {cli_seconds:.3f} s")
    _same_files(out_run, out_cli)

    st = _stats(out_cli)
    dedup = _lines(os.path.join(out_cli, "sample_dedup.fastq"))
    ann = _lines(os.path.join(out_cli, "sample_annotated.fastq"))
    if dedup != 4 * st["clusters"] or ann != 4 * st["total"]:
        raise SmokeFailure(f"line counts: dedup {dedup} annotated {ann} "
                           f"vs stats {st}")
    say(f"phase 4 outputs: stats {json.dumps(st)}; dedup lines == 4 x "
        f"clusters; annotated lines == 4 x total")

    ref_check = "skipped (no g++ or zlib.h)"
    gxx = shutil.which("g++")
    if gxx and os.path.exists("/usr/include/zlib.h"):
        exe = os.path.join(WORK, "humid_ref")
        subprocess.run([gxx, "-O2", "-std=c++17", "-o", exe,
                        os.path.join(REPO, "baseline", "humid_ref.cpp"),
                        "-lz"], check=True)
        out_ref = os.path.join(WORK, "out_ref")
        os.makedirs(out_ref)
        t0 = time.perf_counter()
        subprocess.run([exe, *flags, "-d", out_ref, "-l", os.devnull, fq],
                       check=True, capture_output=True)
        ref_seconds = time.perf_counter() - t0
        _same_files(out_ref, out_cli)
        ref_check = f"byte-identical to baseline/humid_ref ({ref_seconds:.3f} s)"
    say(f"phase 4 reference check: {ref_check}")
    have_ref = bool(gxx and os.path.exists("/usr/include/zlib.h"))
    return {"seconds": seconds, "cli_seconds": cli_seconds,
            "launches": launches, "engine": engine,
            "uniques": len(res.counts),
            "timings": res.extra["timings"], "stats": st, "fastq": fq,
            "flags": flags,
            "humid_ref": os.path.join(WORK, "humid_ref") if have_ref else None,
            "outs": [out_run] + ([out_ref] if have_ref else [])}


def _equal_pairs(name, got, want) -> int:
    """``got`` and ``want`` are (a, b) of numpy arrays or tensors.  Raises
    unless they are equal; returns the largest absolute difference found
    (0 when it returns)."""
    host = lambda x: x.cpu().numpy() if hasattr(x, "cpu") else x
    err = 0
    for g, w_ in zip(got, want):
        g, w_ = host(g), host(w_)
        if g.shape != w_.shape:
            raise SmokeFailure(f"{name}: {len(g)} pairs against {len(w_)}")
        if len(g):
            err = max(err, int(np.abs(g - w_).max()))
    if err:
        raise SmokeFailure(f"{name}: pair arrays differ (max abs err {err})")
    return err


def _lanes(packed, device):
    import torch

    return torch.from_numpy(np.ascontiguousarray(packed, np.uint32).view(
        np.int32)).to(device)


def ring_step_phase(device, table_w2, table_w3) -> int:
    """Phase 5: the ring kernel against its plain version, one step.  The
    blocks are rows [0, b) and [b, 2b) of an ascending unique table, and
    u = b + b/2 cuts the second block in the middle: on an ``upper_only``
    step that block is rows and columns, else it is the columns.  Returns
    the largest absolute difference between kernel and plain pairs."""
    from humid_tpu_torch.parallel import cuda_ring as R

    b3 = len(table_w3) // 2
    cases = [("w2_m1", table_w2, 16384, 1, True),
             ("w2_m1", table_w2, 16384, 1, False),
             ("w3_m2", table_w3, b3, 2, True),
             ("w3_m2", table_w3, b3, 2, False),
             ("w3_all_pairs", table_w3, 2048, 48, False)]
    worst = 0
    for name, table, b, m, upper_only in cases:
        cols = _lanes(table[b:2 * b], device)
        rows = cols if upper_only else _lanes(table[:b], device)
        kw = dict(row_base=b if upper_only else 0, col_base=b,
                  u=b + b // 2, max_dist=m, upper_only=upper_only)
        ka, kb = R.ring_block_pairs(rows, cols, **kw)
        pa, pb = R.ring_block_pairs_plain(rows, cols, **kw)
        err = _equal_pairs(f"phase 5 {name}", (ka, kb), (pa, pb))
        worst = max(worst, err)
        _equal_pairs(f"phase 5 {name} (second launch)",
                     R.ring_block_pairs(rows, cols, **kw), (ka, kb))
        if not len(ka):
            raise SmokeFailure(f"phase 5 {name}: no pair found")
        if int(kb.max()) >= kw["u"]:
            raise SmokeFailure(f"phase 5 {name}: a padding row matched")
        if m >= 48 and len(ka) != b * (b // 2):
            raise SmokeFailure(f"phase 5 {name}: {len(ka)} pairs, expected "
                               f"every valid one ({b * (b // 2)})")
        ms = time_cuda(lambda: R.ring_block_pairs(rows, cols, **kw), 5)
        plain = time_cuda(
            lambda: R.ring_block_pairs_plain(rows, cols, **kw), 1)
        say(f"phase 5 {name} upper_only={upper_only}: kernel == plain "
            f"(tolerance 0, max abs err {err}); b {b}, pairs {len(ka)}, "
            f"kernel {ms:.3f} ms, plain {plain:.3f} ms")
    return worst


def ids_phase(device, uniq, card) -> None:
    """Phase 6: the tile sweep with a run-id mask against its plain
    version, on shard 0's input of the bucketed mesh search.  Its bound
    counts every valid pair of the tile pairs, as without ids: the mask
    is looked at after the distance, it spares the kernel no compare."""
    import torch

    from humid_tpu_torch.ops import cuda_hamming as K
    from humid_tpu_torch.ops.neighbors import sweep_tensors
    from humid_tpu_torch.parallel.neighbors import bucketed_shard_inputs

    prep = bucketed_shard_inputs(uniq, 1, 24, 4)
    lanes, tp = sweep_tensors(prep["rows"][0], prep["tile_pairs"][0], device)
    ids = torch.from_numpy(prep["ids"][0]).to(device)
    kw = dict(tile=prep["tile"], part_stride=prep["r_pad"],
              part_valid=prep["urows"][0], max_dist=1, ids=ids)
    got = K.hamming_tile_pairs(lanes, tp, **kw)
    _equal_pairs("phase 6", got, K.hamming_tile_pairs_plain(lanes, tp, **kw))
    _equal_pairs("phase 6 (second launch)",
                 K.hamming_tile_pairs(lanes, tp, **kw), got)
    free = K.hamming_tile_pairs(lanes, tp, **{**kw, "ids": None})
    if not 0 < len(got[0]) <= len(free[0]):
        raise SmokeFailure(f"phase 6: {len(got[0])} masked pairs against "
                           f"{len(free[0])} unmasked")
    kernel_ms = sweep_kernel_ms(lanes, tp, kw, len(got[0]), 20)
    ms = time_cuda(lambda: K.hamming_tile_pairs(lanes, tp, **kw), 5)
    free_ms = time_cuda(
        lambda: K.hamming_tile_pairs(lanes, tp, **{**kw, "ids": None}), 5)
    plain_ms = time_cuda(lambda: K.hamming_tile_pairs_plain(lanes, tp, **kw),
                         1)
    evaluations = sweep_evaluations(
        len(prep["rows"][0]), prep["tile_pairs"][0], prep["tile"],
        prep["r_pad"], prep["urows"][0])
    n_bytes = k1_bytes(lanes, tp, len(got[0]), ids)
    bound = simplex_bound(evaluations, int(lanes.shape[1]), n_bytes)
    share = within_bound("phase 6", kernel_ms, bound)
    roof = roofline(evaluations, int(lanes.shape[1]), n_bytes, card)
    roof_share = within_bound("phase 6", kernel_ms, roof, "roofline_ms")
    say(f"phase 6: tile sweep with ids == plain (tolerance 0); shard 0 of "
        f"4: {prep['urows'][0]} rows, tile {prep['tile']}, {len(tp)} tile "
        f"pairs, {len(got[0])} pairs ({len(free[0])} without the mask), "
        f"{evaluations} evaluations; kernel alone {kernel_ms:.4f} ms, bound "
        f"{bound['bound_ms']:.4f} ms ({bound['form']}, {bound['bound_by']}; "
        f"share "
        f"{share:.3f}); roofline {roof['roofline_ms']:.4f} ms "
        f"({roof['roofline_form']}, {roof['roofline_by']}; share "
        f"{roof_share:.3f}); wrapper {ms:.3f} ms with ids, {free_ms:.3f} ms "
        f"without; plain version {plain_ms:.3f} ms")


def plain_ring(uniq, max_dist, d, device):
    """The ring schedule driven through the plain step, on the card."""
    import torch

    from humid_tpu_torch.parallel import cuda_ring as R
    from humid_tpu_torch.parallel.mesh import pad_to_shards

    u = len(uniq)
    b = -(-u // d)
    lanes = _lanes(pad_to_shards(uniq, d, multiple=1), device)
    outs = []
    for me, s, q, upper_only, emits in R.ring_schedule(d):
        if emits:
            outs.append(R.ring_block_pairs_plain(
                lanes[me * b:(me + 1) * b], lanes[q * b:(q + 1) * b],
                row_base=me * b, col_base=q * b, u=u, max_dist=max_dist,
                upper_only=upper_only))
    key = torch.sort(torch.cat([a * u + bb for a, bb in outs])).values
    return (key // u).cpu().numpy(), (key % u).cpu().numpy()


def _wall_ms(fn, reps: int = 3) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def ring_schedule_phase(device, table) -> None:
    """Phase 7: the whole ring for several shard counts on one card."""
    from humid_tpu_torch import parallel as P
    from humid_tpu_torch.ops.neighbors import find_neighbor_pairs

    dense = find_neighbor_pairs(table, 1, word_length=24, strategy="dense",
                                device=device)
    _equal_pairs("phase 7 plain ring (3 shards) vs dense sweep",
                 plain_ring(table, 1, 3, device), dense)
    if len(table) != 65536 or not len(dense[0]):
        raise SmokeFailure(f"phase 7: {len(table)} uniques, "
                           f"{len(dense[0])} pairs")
    for d in (1, 2, 3, 4, 8):
        mesh = P.data_mesh(d, device)
        for run in (1, 2):
            _equal_pairs(f"phase 7 ring, {d} shards, run {run}",
                         P.sharded_neighbor_pairs_ring(
                             table, 1, word_length=24, mesh=mesh), dense)
    times = {d: _wall_ms(lambda: P.sharded_neighbor_pairs_ring(
        table, 1, word_length=24, mesh=P.data_mesh(d, device)))
        for d in (1, 4)}
    say(f"phase 7: ring on {len(table)} uniques == plain ring == dense "
        f"sweep for 1, 2, 3, 4, 8 shards, twice each ({len(dense[0])} "
        f"pairs); whole-ring wall 1 shard {times[1]:.3f} ms, 4 shards "
        f"{times[4]:.3f} ms")


def ring_main_shape_phase(device, uniq, card) -> dict:
    """Phase 8: the ring at the main path's size, 4 shards; times of the
    kernel alone (the schedule's launches over blocks encoded beforehand,
    between two CUDA events; and with no pair passing), of the encoder
    per step, of the whole ring call, and of one step's kernel alone,
    wrapper and plain version."""
    import torch

    from humid_tpu_torch import parallel as P
    from humid_tpu_torch.ops import simplex_encode as SE
    from humid_tpu_torch.ops.neighbors import find_neighbor_pairs
    from humid_tpu_torch.parallel import cuda_ring as R
    from humid_tpu_torch.parallel.mesh import pad_to_shards

    d, u, w = 4, len(uniq), uniq.shape[1]
    mesh = P.data_mesh(d, device)
    want = find_neighbor_pairs(uniq, 1, word_length=24, strategy="bucketed",
                               device=device)
    R.LAUNCHES = SE.LAUNCHES = 0
    got = P.sharded_neighbor_pairs_ring(uniq, 1, word_length=24, mesh=mesh)
    launches, encodes = R.LAUNCHES, SE.LAUNCHES
    _equal_pairs("phase 8 ring (4 shards) vs bucketed sweep", got, want)
    ring_wall = _wall_ms(lambda: P.sharded_neighbor_pairs_ring(
        uniq, 1, word_length=24, mesh=mesh))

    b = -(-u // d)
    lanes = _lanes(pad_to_shards(uniq, d, multiple=1), device)
    blocks = [lanes[i * b:(i + 1) * b] for i in range(d)]
    # The encoder against its plain version, byte for byte, on each block.
    tables = [SE.encode(blk) for blk in blocks]
    plain_tables = [SE.encode_table(blk) for blk in blocks]
    encode_err = max(int((t.int() - p.int()).abs().max())
                     for t, p in zip(tables, plain_tables))
    if encode_err:
        raise SmokeFailure(f"phase 8: the encoder differs from encode_table "
                           f"(max abs err {encode_err})")
    steps = [(me, q, up) for me, s, q, up, emits in R.ring_schedule(d)
             if emits]
    valid = [max(0, min(u - i * b, b)) for i in range(d)]
    evaluations = sum(valid[me] * (valid[me] - 1) // 2 if up
                      else valid[me] * valid[q] for me, q, up in steps)
    buf = R._PairBuffer.new(R.CAP_START, device)
    work = torch.zeros(len(steps), dtype=torch.int64, device=device)

    def all_steps(max_dist):
        def run():
            buf.counter.zero_()
            work.zero_()
            for i, (me, q, up) in enumerate(steps):
                R._step(blocks[me], blocks[q], buf, row_base=me * b,
                        col_base=q * b, u=u, max_dist=max_dist,
                        upper_only=up, tables=(tables[me], tables[q]),
                        work=work[i])
        return run

    kernel_ms = time_cuda(all_steps(1), 10)
    if int(buf.counter.item()) != len(want[0]):
        raise SmokeFailure(f"phase 8: the timed launches counted "
                           f"{int(buf.counter.item())} pairs, expected "
                           f"{len(want[0])}")
    no_hit_ms = time_cuda(all_steps(-1), 10)
    if int(buf.counter.item()):
        raise SmokeFailure("phase 8: a pair passed at max_dist -1")
    # One step at this shape: shard 0 against block 1 (not upper_only).
    kw = dict(row_base=0, col_base=b, u=u, max_dist=1, upper_only=False)
    step = R.ring_block_pairs(blocks[0], blocks[1], **kw)
    step_err = _equal_pairs(
        "phase 8 one step vs plain", step,
        R.ring_block_pairs_plain(blocks[0], blocks[1], **kw))
    ms = time_cuda(lambda: R.ring_block_pairs(blocks[0], blocks[1], **kw), 5)
    plain_ms = time_cuda(
        lambda: R.ring_block_pairs_plain(blocks[0], blocks[1], **kw), 1)

    def one_step(max_dist):
        def run():
            buf.counter.zero_()
            work[:1].zero_()
            R._step(blocks[0], blocks[1], buf, tables=tables[:2],
                    work=work[0], **{**kw, "max_dist": max_dist})
        return run

    step_kernel_ms = time_cuda(one_step(1), 20)
    if int(buf.counter.item()) != len(step[0]):
        raise SmokeFailure(f"phase 8: the timed step counted "
                           f"{int(buf.counter.item())} pairs, expected "
                           f"{len(step[0])}")
    step_no_hit_ms = time_cuda(one_step(-1), 20)
    # The encoder per step: one received block into the shard's buffer.
    received = torch.empty_like(tables[1])
    encode_ms = time_cuda(lambda: SE.encode(blocks[1], out=received), 20)
    # Back-to-back launches this short are paced by the host's set-up:
    # the kernel's own time, from the profiler's trace.
    encode_trace = kernels_launched(
        lambda: SE.encode(blocks[1], out=received), "phase8_encode",
        "simplex_encode_kernel")
    # None where the trace lost the kernel's event (PERF.md §7).
    encode_device_ms = (encode_trace["named_busy_ms"]
                        if encode_trace["named"] else None)
    encode_plain_ms = time_cuda(lambda: SE.encode_table(blocks[1]), 5)
    slot_bytes, encoded_bytes = b * w * 4, tables[0].numel()
    encode_bound_ms = (slot_bytes + encoded_bytes) / 3.35e12 * 1e3
    step_bytes = 2 * encoded_bytes + 8 * len(step[0])
    ring_bytes = len(steps) * 2 * encoded_bytes + 8 * len(want[0])
    step_bound = simplex_bound(valid[0] * valid[1], w, step_bytes)
    ring_bound = simplex_bound(evaluations, w, ring_bytes)
    step_roof = roofline(valid[0] * valid[1], w, step_bytes, card)
    ring_roof = roofline(evaluations, w, ring_bytes, card)
    out = {"uniques": u, "shards": d, "block_rows": b,
           "launches_per_ring": launches, "encodes_per_ring": encodes,
           "evaluations": evaluations,
           "pairs": len(want[0]), "kernel_ms_all_steps": kernel_ms,
           "no_hit_kernel_ms_all_steps": no_hit_ms,
           "evaluations_per_s": evaluations / (kernel_ms * 1e-3),
           "ring_bound_ms": ring_bound["bound_ms"],
           "ring_bound_share": within_bound("phase 8 ring", kernel_ms,
                                            ring_bound),
           "ring_roofline_ms": ring_roof["roofline_ms"],
           "ring_roofline_share": within_bound("phase 8 ring", kernel_ms,
                                               ring_roof, "roofline_ms"),
           "ring_wall_ms": ring_wall, "slot_bytes": slot_bytes,
           "encoded_bytes": encoded_bytes, "encode_ms": encode_ms,
           "encode_device_ms": encode_device_ms,
           "encode_plain_ms": encode_plain_ms,
           "encode_bound_ms": encode_bound_ms,
           "encode_bound_share": within_bound(
               "phase 8 encoder", encode_device_ms or encode_ms,
               {"bound_ms": encode_bound_ms}),
           "encode_max_abs_err": encode_err,
           "step_kernel_ms": step_kernel_ms,
           "step_no_hit_kernel_ms": step_no_hit_ms, "step_ms": ms,
           "step_plain_ms": plain_ms, "max_abs_err": step_err,
           **step_bound,
           "bound_share": within_bound("phase 8 step", step_kernel_ms,
                                       step_bound), **step_roof,
           "roofline_share": within_bound("phase 8 step", step_kernel_ms,
                                          step_roof, "roofline_ms")}
    say(f"phase 8: ring at the main path's size == bucketed sweep; "
        f"{json.dumps(out)}")
    return out


def mesh_end_to_end_phase(e2e: dict, device: str = "cuda") -> dict:
    """Phase 9: the phase-4 file through the mesh engines."""
    import humid_tpu_torch
    from humid_tpu_torch.ops import cuda_hamming
    from humid_tpu_torch.parallel import cuda_ring, data_mesh

    fq = e2e["fastq"]
    counts = {}
    for strategy, mod in (("ring", cuda_ring),
                          ("sharded_bucketed", cuda_hamming)):
        out = os.path.join(WORK, f"out_{strategy}")
        cuda_ring.LAUNCHES = cuda_hamming.LAUNCHES = 0
        t0 = time.perf_counter()
        res = humid_tpu_torch.run(
            [fq], word_length=24, distance=1, dir_name=out,
            log_name=os.path.join(WORK, f"{strategy}.log"), run_stats=True,
            write_annotated=True, device=device,
            neighbor_opts={"strategy": strategy,
                           "mesh": data_mesh(4, device)})
        seconds = time.perf_counter() - t0
        counts[strategy] = mod.LAUNCHES
        engine = res.extra["engine"]
        say(f"phase 9 run() strategy={strategy}: {seconds:.3f} s, ring "
            f"launches {cuda_ring.LAUNCHES}, tile sweep launches "
            f"{cuda_hamming.LAUNCHES}, engine {json.dumps(engine)}, "
            f"neighbours "
            f"{res.extra['timings']['Calculating neighbours using Hamming distance']:.3f} s")
        if counts[strategy] < 1:
            raise SmokeFailure(f"strategy {strategy} launched no kernel of "
                               f"{mod.__name__}")
        if ({k: v for k, v in engine.items() if k != "unique"}
                != {"metric": "hamming", "strategy": strategy, "shards": 4,
                    "ring_fallbacks": 0}
                or engine["unique"] not in ("host", "device")):
            raise SmokeFailure(f"unexpected engine record {engine}")
        for ref in e2e["outs"]:
            _same_files(ref, out)
    out_cli = os.path.join(WORK, "out_cli_ring")
    env = dict(os.environ, HUMID_TPU_TORCH_DEVICE=device,
               HUMID_TPU_TORCH_STRATEGY="ring", HUMID_TPU_TORCH_SHARDS="4")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "humid_tpu_torch", *e2e["flags"], "-d",
         out_cli, "-l", os.path.join(WORK, "cli_ring.log"), fq],
        cwd=REPO, env=env, capture_output=True, text=True)
    if proc.returncode:
        raise SmokeFailure(f"python -m humid_tpu_torch (ring) failed:\n"
                           f"{proc.stderr}")
    for ref in e2e["outs"]:
        _same_files(ref, out_cli)
    say(f"phase 9 python -m humid_tpu_torch with HUMID_TPU_TORCH_STRATEGY="
        f"ring HUMID_TPU_TORCH_SHARDS=4: {time.perf_counter() - t0:.3f} s; "
        f"all mesh outputs byte-identical to phase 4's"
        + (" and to baseline/humid_ref" if len(e2e["outs"]) > 1 else ""))
    return counts


def _levenshtein(x, y) -> int:
    """Scalar Levenshtein distance (full DP, no band)."""
    row = list(range(len(y) + 1))
    for i in range(1, len(x) + 1):
        nrow = [i]
        for j in range(1, len(y) + 1):
            nrow.append(min(row[j - 1] + (x[i - 1] != y[j - 1]), row[j] + 1,
                            nrow[-1] + 1))
        row = nrow
    return row[-1]


def _edited_codes(rng, n, length, m, pool):
    """[n, length] uint8 codes: pool words, some with a substitution, some
    shifted right by up to m bases (an indel at each end)."""
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


def with_indels(table, length: int, n: int, seed: int):
    """A unique table of ``n`` words, ascending: the first 4n/5 words of
    ``table`` plus, for every fourth of them, a copy shifted right by one
    base behind a random first base (an insertion at the head and a
    deletion at the tail).  A shifted copy is within edit distance 2 of
    its source and, as a rule, far from it in Hamming distance."""
    from humid_tpu_torch import words as W
    from humid_tpu_torch.ops import unique_words

    rng = np.random.default_rng(seed)
    codes = W.unpack_words(table[:-(-4 * n // 5) + 8], length)
    shifted = codes[::4].copy()
    shifted[:, 1:] = codes[::4, :-1]
    shifted[:, 0] = rng.integers(0, 4, len(shifted), dtype=np.uint8)
    return unique_words(W.pack_words(np.concatenate([codes, shifted])),
                        want_inverse=False)[0][:n]


def _equal_tensors(name, got, want) -> None:
    import torch

    if not torch.equal(got.cpu(), want.cpu()):
        raise SmokeFailure(f"{name}: the card and the CPU differ")


def edit_dp_phase(device) -> None:
    """Phase 10: the banded-Levenshtein programs on the card against the
    CPU and a scalar Levenshtein (integer work: tolerance 0)."""
    import torch

    from humid_tpu_torch import words as W
    from humid_tpu_torch.ops import edit as E

    for length in (18, 24, 33):
        for m in (1, 2, 3):
            rng = np.random.default_rng(100 * m + length)
            codes = _edited_codes(rng, 1536, length, m, pool=24)
            a = torch.from_numpy(codes[:512].astype(np.int32))
            b = torch.from_numpy(codes[512:1024].astype(np.int32))
            tile = E._banded_levenshtein(a.to(device), b.to(device), m,
                                         length)
            want = E._banded_levenshtein(a, b, m, length)
            name = f"phase 10 L={length} m={m}"
            _equal_tensors(f"{name} tile", tile, want)
            if int(want.min()) != 0 or int(want.max()) != m + 1:
                raise SmokeFailure(f"{name}: distances span "
                                   f"{int(want.min())}..{int(want.max())}")
            for r, c in rng.integers(0, 512, (150, 2)):
                full = _levenshtein(codes[r].tolist(),
                                    codes[512 + c].tolist())
                if int(want[r, c]) != min(full, m + 1):
                    raise SmokeFailure(
                        f"{name}: pair ({r}, {c}) banded {int(want[r, c])} "
                        f"against scalar {full}")
            a3 = torch.from_numpy(codes.astype(np.int32)).view(3, 512, length)
            b3 = a3.flip(0).contiguous()
            _equal_tensors(f"{name} batched",
                           E._banded_levenshtein(a3.to(device),
                                                 b3.to(device), m, length),
                           E._banded_levenshtein(a3, b3, m, length))
            _equal_tensors(f"{name} pairs",
                           E._banded_levenshtein_pairs(
                               a.to(device), b.to(device), m, length),
                           E._banded_levenshtein_pairs(a, b, m, length))
            lanes = torch.from_numpy(W.pack_words(codes).view(np.int32))
            on_card = lanes.to(device)
            blocks = zip(E.edit_block(on_card[:512], on_card[256:768], 0,
                                      256, m, 1 << 12, length),
                         E.edit_block(lanes[:512], lanes[256:768], 0, 256,
                                      m, 1 << 12, length))
            for part, (g, w_) in zip(("rows", "columns", "count"), blocks):
                _equal_tensors(f"{name} edit_block {part}", g, w_)
    say("phase 10: _banded_levenshtein (512 x 512 tile and batched), "
        "_banded_levenshtein_pairs and edit_block on the card == on the CPU "
        "== a scalar Levenshtein at L = 18, 24, 33 and m = 1, 2, 3 "
        "(tolerance 0)")


def kernels_launched(fn, name: str, kernel: str | None = None) -> dict:
    """Device kernels, copies and memsets that one call of ``fn``
    launches, counted in a ``torch.profiler`` trace.  ``kernel_ms`` sums
    the kernels' durations; ``busy_ms`` is the union of their intervals,
    the card's busy time where kernels on several streams overlap (the
    same where they do not).  ``kernel`` names one kernel whose events
    are also counted (``named``) and whose intervals' union is timed
    (``named_busy_ms``).  ``traces`` is how many traces were taken: more
    than 1 where a trace came back without any kernel event."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    path = os.path.join(WORK, f"trace_{name}.json")
    # A trace now and then comes back without any device event (seen once
    # in a single-card label propagation that traces fine otherwise): such
    # a trace is taken again, at most twice.
    for attempt in range(1, 4):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
        os.remove(path)
        kernels = [e for e in events if e.get("cat") == "kernel"]
        if kernels:
            break
    count = lambda cat: sum(1 for e in events if e.get("cat") == cat)
    out = {"kernels": len(kernels), "copies": count("gpu_memcpy"),
           "memsets": count("gpu_memset"),
           "kernel_ms": sum(e["dur"] for e in kernels) / 1e3,
           "busy_ms": _union_ms(kernels)}
    if kernel is not None:
        named = [e for e in kernels if kernel in e["name"]]
        out.update(named=len(named), named_busy_ms=_union_ms(named))
    out["traces"] = attempt
    if not out["kernels"]:
        raise SmokeFailure(f"{name}: {attempt} traces hold no kernel")
    return out


def _union_ms(events) -> float:
    """Milliseconds covered by the union of trace events' intervals."""
    total, end = 0.0, None
    for ts, dur in sorted((e["ts"], e["dur"]) for e in events):
        if end is None or ts > end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total / 1e3


def edit_bounds(pairs: int, m: int, length: int, card: dict) -> dict:
    """Two least times for the banded DP of ``pairs`` word pairs.

    ``ops_bound_ms``: about 8 (2m + 1) L int32 operations a pair (per
    band cell a compare, three adds, three minimums and the clamp) over
    SMs x 64 a clock x the maximum SM clock: what one fused kernel that
    keeps the band in registers could approach.  ``bytes_bound_ms``: what
    the program as written, one elementwise operation after another, must
    move through device memory, over 3.35e12 B/s.  Per DP row and pair:
    the mismatch flags written (band bytes) and read, the state read and
    the new state written (4 band each), the up term's add and minimum
    (5 x 4 (band - 1)), the clamp (8 band), and per chained cell an add
    and a minimum (5 x 4 (band - 1)).  The larger of the two is
    ``bound_ms``; ``bound_by`` says which."""
    band = 2 * m + 1
    ops_ms = pairs * 8 * band * length / (
        64 * card["sms"] * card["sm_hz"]) * 1e3
    row_bytes = 2 * band + 8 * band + 20 * (band - 1) + 8 * band \
        + 20 * (band - 1)
    bytes_ms = pairs * length * row_bytes / 3.35e12 * 1e3
    return {"ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def _with_env(env: dict, fn):
    """``fn()`` with the variables of ``env`` set, restored after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def edit_engines_phase(device, table_l33, table_l24, uniq_1m, card) -> dict:
    """Phase 11: the edit engines against each other on the card, and the
    three edit programs timed at the shapes PERF.md records."""
    import torch

    from humid_tpu_torch import parallel as P
    from humid_tpu_torch.ops import edit as E
    from humid_tpu_torch.ops import neighbors as N
    from humid_tpu_torch.ops.hamming import lanes_tensor

    if len(table_l33) != 8192 or len(table_l24) != 65536:
        raise SmokeFailure(f"phase 11: tables of {len(table_l33)} and "
                           f"{len(table_l24)} uniques")
    for name, table, length, m, ring_shards in (
            ("L33_m2_8192", table_l33, 33, 2, (1, 2, 4)),
            ("L24_m1_65536", table_l24, 24, 1, (4,))):
        kw = dict(metric="edit", word_length=length, device=device)
        N.find_neighbor_pairs(table[:4096], m, strategy="dense", **kw)  # warm
        times = {}
        dense, times["dense"] = _timed(lambda: N.find_neighbor_pairs(
            table, m, strategy="dense", **kw))
        hamming = N.find_neighbor_pairs(table, m, word_length=length,
                                        strategy="dense", device=device)
        # Words of one length: one edit is one substitution, so at m = 1
        # the two metrics agree; from m = 2 on the shifted copies add
        # pairs that only the edit distance finds.
        key = lambda p: p[0] * len(table) + p[1]
        if not (len(hamming[0]) > 0
                and np.isin(key(hamming), key(dense)).all()
                and (len(dense[0]) == len(hamming[0]) if m == 1
                     else len(dense[0]) > len(hamming[0]))):
            raise SmokeFailure(
                f"phase 11 {name}: {len(dense[0])} edit pairs against "
                f"{len(hamming[0])} Hamming pairs at m = {m}")
        info = {}
        got, times["runs"] = _timed(lambda: N.find_neighbor_pairs(
            table, m, strategy="runs", info=info, **kw))
        _equal_pairs(f"phase 11 {name} runs vs dense", got, dense)
        candidates = info["candidates"]
        for d in (1, 2, 4):
            info = {}
            got, times[f"sharded_{d}"] = _timed(
                lambda: N.find_neighbor_pairs(
                    table, m, strategy="sharded",
                    mesh=P.data_mesh(d, device), info=info, **kw))
            _equal_pairs(f"phase 11 {name} sharded on {d} vs dense", got,
                         dense)
            if (info["shards"], info["join_cap_fallbacks"]) != (d, 0) \
                    or not info["candidates"]:
                raise SmokeFailure(f"phase 11 {name}: sharded ran {info}")
        got, times["shifted_mesh_4"] = _timed(
            lambda: P.sharded_edit_pairs_shifted(
                table, m, word_length=length, mesh=P.data_mesh(4, device)))
        _equal_pairs(f"phase 11 {name} shifted mesh search vs dense", got,
                     dense)
        for d in ring_shards:
            got, times[f"edit_ring_{d}"] = _timed(
                lambda: P.sharded_neighbor_pairs(
                    table, m, metric="edit", word_length=length,
                    mesh=P.data_mesh(d, device)))
            _equal_pairs(f"phase 11 {name} dense edit ring on {d} vs dense",
                         got, dense)
        say(f"phase 11 {name}: dense == runs == sharded (1, 2, 4 shards) == "
            f"shifted mesh search == dense edit ring {ring_shards} "
            f"(tolerance 0); {len(dense[0])} pairs ({len(hamming[0])} of "
            f"them within the Hamming distance), {candidates} candidates; "
            f"wall ms {json.dumps(times)}")

    # The three programs, at the shapes PERF.md records.
    programs = {}
    length, m, u = 33, 2, 8192
    codes = E._unpack(lanes_tensor(table_l33, device), length)
    tiles = codes.view(-1, 512, length)
    ii, jj = np.triu_indices(len(tiles))
    ti = torch.from_numpy(ii).to(device)
    tj = torch.from_numpy(jj).to(device)
    dp = lambda: E._banded_levenshtein(tiles[ti], tiles[tj], m, length)
    pairs = len(ii) * 512 * 512
    programs["dense_scan_L33_m2_8192"] = {
        "tile_pairs": len(ii), "pairs_evaluated": pairs,
        "dp_ms": time_cuda(dp, 3), "dp_launches": kernels_launched(
            dp, "dense_dp"),
        "ms": time_cuda(lambda: N.dense_edit_pairs(
            table_l33, m, word_length=length, device=device), 3),
        "launches": kernels_launched(lambda: N.dense_edit_pairs(
            table_l33, m, word_length=length, device=device), "dense_scan"),
        **edit_bounds(pairs, m, length, card)}

    b = u // 4
    all_tiles = np.stack(np.meshgrid(np.arange(b // 512), np.arange(b // 512),
                                     indexing="ij"), axis=-1).reshape(-1, 2)
    step = lambda: E.edit_tile_pairs(
        codes[:b], codes[b:2 * b], all_tiles, tile=512, max_dist=m,
        word_length=length, row_valid=b, col_valid=b, upper_only=False)
    pairs = len(all_tiles) * 512 * 512
    programs["edit_ring_step_L33_m2_block_2048"] = {
        "block_rows": b, "tile_pairs": len(all_tiles),
        "pairs_evaluated": pairs, "matches": len(step()[0]),
        "ms": time_cuda(step, 5),
        "launches": kernels_launched(step, "ring_step"),
        **edit_bounds(pairs, m, length, card)}

    # The verify program on the candidates of the 1M-read table, and the
    # host parts of the shifted search around it (the joins and their
    # first-join union), timed by the search's own spans.
    host_ms, info = {}, {}

    @contextlib.contextmanager
    def host_span(name):
        t0 = time.perf_counter()
        yield
        host_ms[name] = (time.perf_counter() - t0) * 1e3

    ca, cb = N._shifted_candidates(uniq_1m, 1, 24, N.default_join_cap(),
                                   None, host_span, info)
    if info["candidates"] - info["first_join_dropped"] != len(ca) \
            or len(N._dedupe_pairs(ca, cb)[0]) != len(ca):
        raise SmokeFailure(f"phase 11: the first-join union of {len(ca)} "
                           f"pairs is not distinct, or its counters "
                           f"{json.dumps(info)} disagree")
    verify = lambda: E.edit_pairs_verify(uniq_1m, ca, cb, 1, 24,
                                         device=device)
    kept = verify()
    _equal_pairs("phase 11 verify on the card vs the CPU", kept,
                 E.edit_pairs_verify(uniq_1m, ca, cb, 1, 24, device="cpu"))
    lanes = lanes_tensor(uniq_1m, device)
    ia = torch.from_numpy(ca).to(device)
    ib = torch.from_numpy(cb).to(device)
    dp = lambda: E._banded_levenshtein_pairs(
        E._unpack(lanes[ia], 24), E._unpack(lanes[ib], 24), 1, 24)
    programs["verify_1M_read_candidates"] = {
        "uniques": len(uniq_1m), "candidates": info["candidates"],
        "first_join_dropped": info["first_join_dropped"],
        "pairs_evaluated": len(ca), "kept": len(kept[0]),
        "joins_host_ms": host_ms["joins"], "dedupe_host_ms": host_ms["dedupe"],
        "dp_ms": time_cuda(dp, 5), "dp_launches": kernels_launched(
            dp, "verify_dp"),
        "ms": time_cuda(verify, 5),
        "launches": kernels_launched(verify, "verify"),
        **edit_bounds(len(ca), 1, 24, card)}
    for name, rec in programs.items():
        say(f"phase 11 program {name}: {json.dumps(rec)}")
    return programs


def edit_end_to_end_phase(e2e: dict, device: str = "cuda") -> dict:
    """Phase 12: the phase-4 file with -e through run() by the default
    route and by ``sharded`` on 4 shards, and through the CLI."""
    import humid_tpu_torch
    from humid_tpu_torch.ops import cuda_hamming
    from humid_tpu_torch.parallel import cuda_ring, data_mesh

    fq = e2e["fastq"]
    flags = ["-n", "24", "-m", "1", "-e", "-s", "-a"]
    out_ref = None
    if e2e["humid_ref"]:
        out_ref = os.path.join(WORK, "out_ref_edit")
        os.makedirs(out_ref)
        t0 = time.perf_counter()
        subprocess.run([e2e["humid_ref"], *flags, "-d", out_ref, "-l",
                        os.devnull, fq], check=True, capture_output=True)
        say(f"phase 12 baseline/humid_ref -e: "
            f"{time.perf_counter() - t0:.3f} s")
    phase = "Calculating neighbours using Levenshtein distance"
    results = {}
    outs = []
    for name, opts, want in (
            ("auto", {}, {"metric": "edit", "strategy": "runs",
                          "join_cap_fallbacks": 0}),
            ("sharded", {"strategy": "sharded",
                         "mesh": data_mesh(4, device)},
             {"metric": "edit", "strategy": "sharded", "shards": 4,
              "ring_fallbacks": 0, "join_cap_fallbacks": 0})):
        out = os.path.join(WORK, f"out_edit_{name}")
        cuda_ring.LAUNCHES = cuda_hamming.LAUNCHES = 0
        t0 = time.perf_counter()
        res = humid_tpu_torch.run(
            [fq], word_length=24, distance=1, edit=True, dir_name=out,
            log_name=os.path.join(WORK, f"edit_{name}.log"), run_stats=True,
            write_annotated=True, device=device, neighbor_opts=opts)
        seconds = time.perf_counter() - t0
        engine = dict(res.extra["engine"])
        say(f"phase 12 run(edit=True) {name}: {seconds:.3f} s, engine "
            f"{json.dumps(engine)}, timings "
            f"{json.dumps(res.extra['timings'])}")
        candidates = engine.pop("candidates", 0)
        # Counters that depend on the data: the shifted search's, which
        # must agree with each other, and the UMI parse's.
        dropped = engine.pop("first_join_dropped", None)
        distinct = engine.pop("distinct_candidates", None)
        if name == "auto" and (dropped is None
                               or candidates - dropped != distinct):
            raise SmokeFailure(f"phase 12 {name}: the candidates less "
                               f"those an earlier join found are not the "
                               f"distinct candidates: {res.extra['engine']}")
        for counter in ("verify_batches", "edit_pairs", "umi_native_rows"):
            engine.pop(counter, None)
        if engine.pop("unique") not in ("host", "device") \
                or engine != want or not candidates:
            raise SmokeFailure(f"phase 12 {name}: unexpected engine record "
                               f"{res.extra['engine']}")
        if cuda_ring.LAUNCHES or cuda_hamming.LAUNCHES:
            raise SmokeFailure("the edit path launched a Hamming kernel")
        results[name] = {"seconds": seconds, "candidates": candidates,
                         "neighbours_s": res.extra["timings"][phase]}
        outs.append(out)
    out_cli = os.path.join(WORK, "out_cli_edit")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "humid_tpu_torch", *flags, "-d", out_cli,
         "-l", os.path.join(WORK, "cli_edit.log"), fq], cwd=REPO,
        env=dict(os.environ, HUMID_TPU_TORCH_DEVICE=device),
        capture_output=True, text=True)
    if proc.returncode:
        raise SmokeFailure(f"python -m humid_tpu_torch -e failed:\n"
                           f"{proc.stderr}")
    results["cli_seconds"] = time.perf_counter() - t0
    with open(os.path.join(WORK, "cli_edit.log")) as f:
        if phase not in f.read():
            raise SmokeFailure("the CLI's log does not name the Levenshtein "
                               "phase")
    outs.append(out_cli)
    for out in outs[1:]:
        _same_files(outs[0], out)
    if out_ref:
        _same_files(out_ref, outs[0])
    st = _stats(out_cli)
    say(f"phase 12: python -m humid_tpu_torch -e {results['cli_seconds']:.3f}"
        f" s; stats {json.dumps(st)}; default route, sharded on 4 shards "
        f"and the CLI byte-identical"
        + (" to baseline/humid_ref -e" if out_ref
           else " (no g++ or zlib.h: baseline/humid_ref not run)"))
    return results


def edit_indel_end_to_end_phase(e2e: dict, table, length: int = 33,
                                device: str = "cuda") -> None:
    """Phase 12, second part: reads made of ``table``'s words (a table of
    :func:`with_indels`), where -e at m = 2 joins clusters that the
    Hamming distance keeps apart."""
    import humid_tpu_torch
    from humid_tpu_torch import words as W
    from humid_tpu_torch.tools.bench import write_fastq

    rng = np.random.default_rng(12)
    idx = np.concatenate([np.arange(len(table)),
                          rng.integers(0, len(table), 2 * len(table))])
    rng.shuffle(idx)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    fq = os.path.join(WORK, "indels.fastq")
    write_fastq(fq, bases[W.unpack_words(table, length)[idx]])
    clusters = {}
    for name, edit in (("hamming", False), ("edit", True)):
        out = os.path.join(WORK, f"out_indels_{name}")
        res = humid_tpu_torch.run(
            [fq], word_length=length, distance=2, edit=edit, dir_name=out,
            log_name=os.devnull, run_stats=True, write_annotated=True,
            device=device)
        engine = res.extra["engine"]
        if (engine["metric"], engine["strategy"]) != (
                name, "runs" if edit
                else default_hamming_engine(device, fq, len(table))):
            raise SmokeFailure(f"phase 12 indels {name}: engine {engine}")
        clusters[name] = _stats(out)["clusters"]
        if e2e["humid_ref"]:
            out_ref = os.path.join(WORK, f"out_ref_indels_{name}")
            os.makedirs(out_ref)
            subprocess.run(
                [e2e["humid_ref"], "-n", str(length), "-m", "2", "-s", "-a",
                 *(["-e"] if edit else []), "-d", out_ref, "-l", os.devnull,
                 fq], check=True, capture_output=True)
            _same_files(out_ref, out)
    if not clusters["edit"] < clusters["hamming"]:
        raise SmokeFailure(f"phase 12 indels: -e left {clusters['edit']} "
                           f"clusters, Hamming {clusters['hamming']}")
    say(f"phase 12 indels: {len(idx)} reads of {len(table)} words, -n "
        f"{length} -m 2: {clusters['hamming']} clusters, with -e "
        f"{clusters['edit']}; both runs byte-identical"
        + (" to baseline/humid_ref with the same flags" if e2e["humid_ref"]
           else " (baseline/humid_ref not run)"))


def default_hamming_engine(device, fastq: str, u: int) -> str:
    """The engine the default route takes for a Hamming run of ``fastq``
    whose table of ``u`` uniques is above the size gate: the fused route
    when the router says so at the run's read estimate, else the router's
    neighbour engine at ``u``."""
    import torch

    from humid_tpu_torch import _backend as B
    from humid_tpu_torch.pipeline import reads_estimate

    dev = torch.device(device)
    return ("fused" if B.use_fused_pipeline(dev, reads_estimate([fastq]))
            else B.pick_neighbor_engine(dev, u))


def calibration_phase(device, tables) -> dict:
    """Phase 13 (run before phase 4, whose default route reads its result):
    the router's calibration, once, into the scratch cache that main()
    names in HUMID_TPU_TORCH_CALIB_PATH; both probes' times of every
    engine, the two parameters fitted to them, and the choices they make
    at the sweep tables' sizes (neighbours) and at 1M and 10M reads
    (fused or not)."""
    from humid_tpu_torch import _backend as B

    t0 = time.perf_counter()
    constants = B.engine_constants(device, refresh=True)
    seconds = time.perf_counter() - t0
    sizes = {name: len(t) for name, t in tables.items()
             if name.startswith("bucketed_")}
    choices = {
        "neighbors": {name: B.pick_neighbor_engine(device, u)
                      for name, u in sizes.items()},
        "unique_on_device": B.use_device_engine("unique", device),
        "components_on_device": B.use_device_engine("cc", device),
        "fused": {n: B.use_fused_pipeline(device, n)
                  for n in (1_000_000, 10_000_000)}}
    for k, ms in constants["probe_ms"].items():
        say(f"phase 13 {k}: probes {constants['probe_n']} reads / "
            f"{constants['probe_u']} uniques: {ms} ms; fitted [fixed ns, "
            f"size ns] {constants[k]}"
            + (" (size: uniques squared)" if k in B._QUADRATIC else ""))
    say(f"phase 13: calibrated in {seconds:.3f} s (both probes); spread "
        f"{constants['spread']}; choices {json.dumps(choices)}")
    return {"constants": constants, "choices": choices, "seconds": seconds}


def sample_reads(n_reads: int, seed: int, length: int = 24) -> np.ndarray:
    """[n_reads, w] packed words of an n-read sample by the benchmark recipe
    (gen_dataset's pool of n/8 sequences, 30% of reads with one substitution
    at a uniform position of 100), first ``length`` bases, in read order."""
    from humid_tpu_torch import words as W

    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 4, (n_reads // 8, length), dtype=np.uint8)
    codes = pool[rng.integers(0, len(pool), n_reads)]
    pos = rng.integers(0, 100, n_reads)
    hit = np.flatnonzero((rng.random(n_reads) < 0.3) & (pos < length))
    codes[hit, pos[hit]] = rng.integers(0, 4, len(hit), dtype=np.uint8)
    return W.pack_words(codes)


def engines_agree_phase(device, tables,
                        probe_reads=(1_000_000, 10_000_000)) -> dict:
    """Phase 14: on the sweep_1M and sweep_10M tables the host runs engine,
    the device runs engine, the bucketed tile sweep, the dense tile sweep
    and, with several cards, the bucketed mesh search over all of them
    give identical pair arrays; each engine's wall time (best of 2) beside
    the router's pick and predictions at the table's size, and the pick
    may be no slower than the fastest engine by more than the
    calibration's spread + 10%.  fused_probe on 1M and 10M packed reads
    (benchmark recipe) equals host unique_words + the runs engine; a
    feeder that starts at an eighth of 10M rows grows and holds every
    row.  Returns the records and the runs engine's pairs per table."""
    import torch

    from humid_tpu_torch.ops import fused as F
    from humid_tpu_torch.ops import neighbors as N
    from humid_tpu_torch.ops import unique_words
    from humid_tpu_torch.ops.hamming import lanes_tensor

    from humid_tpu_torch import _backend as B

    strategies = ["runs", "runs_device", "bucketed", "dense"]
    if torch.cuda.device_count() > 1:
        strategies.append("sharded_bucketed")  # the mesh of every card
    c = B.engine_constants(device)
    margin = float(c["spread"]) + 0.1
    out, runs_pairs = {}, {}
    for name in ("bucketed_1M_reads", "bucketed_10M_reads"):
        uniq = tables[name]
        got, times, infos = {}, {}, {}
        for strategy in strategies:
            infos[strategy] = {}
            run = lambda: N.find_neighbor_pairs(
                uniq, 1, word_length=24, strategy=strategy, device=device,
                info=infos[strategy])
            got[strategy], first = _timed(run)
            times[strategy] = min(first, _timed(run)[1])
        for strategy in strategies[1:]:
            _equal_pairs(f"phase 14 {name} {strategy} vs runs",
                         got[strategy], got["runs"])
        runs_pairs[name] = got["runs"]
        pick = B.pick_neighbor_engine(device, len(uniq))
        fastest = min(times, key=times.get)
        predicted = {s: t / 1e6 for s, t in B.neighbor_times_ns(
            c, len(uniq)).items()}
        out[name] = {"uniques": len(uniq), "pairs": len(got["runs"][0]),
                     "wall_ms": times, "pick": pick,
                     "predicted_ms": predicted, "fastest": fastest,
                     "runs": infos["runs"],
                     "runs_device": infos["runs_device"]}
        say(f"phase 14 {name}: {' == '.join(strategies)} (tolerance 0); "
            f"wall ms best of 2; the router's pick at {len(uniq)} uniques "
            f"is {pick}; {json.dumps(out[name])}")
        if times[pick] > (1.0 + margin) * times[fastest]:
            raise SmokeFailure(
                f"phase 14 {name}: the router picks {pick} "
                f"({times[pick]:.3f} ms), slower than {fastest} "
                f"({times[fastest]:.3f} ms) by more than the spread + 10% "
                f"({margin:.3f})")
    for n_reads in probe_reads:
        packed = sample_reads(n_reads, seed=n_reads % 1009)
        uniq, counts, first, _ = unique_words(packed, want_inverse=False)
        want = N.find_neighbor_pairs(uniq, 1, word_length=24,
                                     strategy="runs", device=device)
        (k, fc, ff, pairs), ms = _timed(
            lambda: F.fused_probe(packed, 24, 1, device=device))
        if k != len(uniq) or not (np.array_equal(fc, counts)
                                  and np.array_equal(ff, first)):
            raise SmokeFailure(f"phase 14 fused_probe {n_reads}: tables "
                               f"differ ({k} uniques against {len(uniq)})")
        _equal_pairs(f"phase 14 fused_probe {n_reads}", pairs, want)
        feeder = F.DeviceFeeder(packed.shape[1], n_reads // 8,
                                device=device)
        cap0 = feeder.cap
        for lo in range(0, n_reads, 1 << 17):
            feeder.push(packed[lo:lo + (1 << 17)])
        buf = feeder.finish()
        if not (torch.equal(buf[:n_reads], lanes_tensor(packed, device))
                and bool((buf[n_reads:] == -1).all())):
            raise SmokeFailure(f"phase 14 feeder at {n_reads} rows: rows "
                               f"differ after growth to {feeder.cap}")
        out[f"fused_probe_{n_reads}"] = {"uniques": k, "pairs": len(pairs[0]),
                                         "wall_ms": ms}
        say(f"phase 14 fused_probe on {n_reads} reads == host unique_words "
            f"+ runs; a feeder of {cap0} rows grown to {feeder.cap} holds "
            f"every row; {json.dumps(out[f'fused_probe_{n_reads}'])}")
    return out, runs_pairs


def k1_intervals(fn):
    """``fn()`` with every K1 launch bracketed by CUDA events on its card's
    stream, on one clock: before the call every card's stream waits for
    one gate event, recorded on card 0 after a short sleep kernel there,
    and then records its anchor, so the anchors fire together and each
    card's events are read against its own anchor.  Returns fn's result
    and, per card index, its launches and the [first start, last end] ms
    of its K1 kernels after the gate."""
    import torch

    from humid_tpu_torch.ops import cuda_hamming as K

    n_cards = torch.cuda.device_count()
    for i in range(n_cards):
        torch.cuda.synchronize(i)
    gate = torch.cuda.Event()
    with torch.cuda.device(0):
        torch.cuda._sleep(1 << 21)  # ~1 ms: every wait below is enqueued
        gate.record()
    anchors = {}
    for i in range(n_cards):
        with torch.cuda.device(i):
            torch.cuda.current_stream().wait_event(gate)
            anchors[i] = torch.cuda.Event(enable_timing=True)
            anchors[i].record()
    real = K._launch
    marks = []

    def launch(lanes, *args, **kw):
        with torch.cuda.device(lanes.device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            real(lanes, *args, **kw)
            end.record()
        marks.append((lanes.device.index, start, end))

    K._launch = launch
    try:
        out = fn()
    finally:
        K._launch = real
    for i in range(n_cards):
        torch.cuda.synchronize(i)
    cards = {}
    for card, a, b in marks:
        rec = cards.setdefault(card, {"launches": 0, "start_ms": np.inf,
                                      "end_ms": -np.inf})
        rec["launches"] += 1
        rec["start_ms"] = min(rec["start_ms"],
                              anchors[card].elapsed_time(a))
        rec["end_ms"] = max(rec["end_ms"], anchors[card].elapsed_time(b))
    return out, cards


def _overlapping(cards: dict) -> list:
    """Pairs of cards whose K1 intervals intersect."""
    ids = sorted(cards)
    return [(c, d) for i, c in enumerate(ids) for d in ids[i + 1:]
            if cards[c]["start_ms"] < cards[d]["end_ms"]
            and cards[d]["start_ms"] < cards[c]["end_ms"]]


def mesh_search_phase(device, tables, runs_pairs) -> dict:
    """Phase 25: the bucketed mesh search on ``data_mesh(4)`` over every
    card there is (one shard a card on four cards; the four shards
    round-robin on one card), at the sweep_1M and sweep_10M tables,
    against the runs engine's pairs of phase 14 (tolerance 0).  Wall ms
    (mean of 3 after a warm-up) and the host prep's share of the same
    calls, K1 launches per card and, where there are several cards, the
    cards' K1 intervals on one clock (``k1_intervals``) and the pairs of
    cards whose kernels overlapped (``--mesh`` requires one at
    sweep_10M).  K1's launches at sweep_1M are counted for the kernels
    line."""
    import torch

    from humid_tpu_torch import parallel as P
    from humid_tpu_torch.ops import cuda_hamming as K
    from humid_tpu_torch.parallel import neighbors as PN

    mesh = P.data_mesh(4, device)
    n_cards = torch.cuda.device_count()
    out = {"shards": len(mesh), "cards": n_cards}
    prep = PN.bucketed_shard_inputs
    for name in ("bucketed_1M_reads", "bucketed_10M_reads"):
        uniq = tables[name]
        search = lambda: P.sharded_neighbor_pairs_bucketed(
            uniq, 1, word_length=24, mesh=mesh)
        K.LAUNCHES = 0
        got = search()
        launches = K.LAUNCHES
        _equal_pairs(f"phase 25 {name} mesh vs runs", got, runs_pairs[name])
        got, cards = k1_intervals(search)
        _equal_pairs(f"phase 25 {name} mesh (timed) vs runs", got,
                     runs_pairs[name])
        prep_s = []

        def timed_prep(*args, **kw):
            t0 = time.perf_counter()
            try:
                return prep(*args, **kw)
            finally:
                prep_s.append(time.perf_counter() - t0)

        PN.bucketed_shard_inputs = timed_prep
        try:
            wall = _wall_ms(search)
        finally:
            PN.bucketed_shard_inputs = prep
        prep_ms = sum(prep_s[1:]) / len(prep_s[1:]) * 1e3  # after warm-up
        rec = {"uniques": len(uniq), "pairs": len(got[0]),
               "launches": launches, "wall_ms": wall, "prep_ms": prep_ms,
               "prep_share": prep_ms / wall,
               "k1_by_card": {c: r["launches"] for c, r in cards.items()},
               "k1_ms_by_card": {c: [r["start_ms"], r["end_ms"]]
                                 for c, r in cards.items()}}
        if len(cards) > 1:
            rec["overlapping_cards"] = _overlapping(cards)
        out[name] = rec
        say(f"phase 25 {name}: mesh search on {len(mesh)} shards == runs "
            f"(tolerance 0); {json.dumps(rec)}")
    if n_cards == 1:
        say("phase 25: one card: its four shards share the card's stream, "
            "so no overlap of shards can be shown here")
    return out


def program_bound(n_bytes: int, int_ops: int, card: dict) -> dict:
    """Least time of a device program: the larger of ``n_bytes`` (each
    input read once, each output written once) over 3.35e12 B/s and
    ``int_ops`` integer operations over SMs x 64 a clock x the maximum SM
    clock."""
    bytes_ms = n_bytes / 3.35e12 * 1e3
    ops_ms = int_ops / (64 * card["sms"] * card["sm_hz"]) * 1e3
    return {"bytes": n_bytes, "int_ops": int_ops, "bytes_bound_ms": bytes_ms,
            "ops_bound_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def programs_phase(device, card, n_reads: int = 1_000_000) -> dict:
    """Phase 15: each device program of the fused and device runs routes at
    e2e_1M's shape (a 1M-read sample by the benchmark recipe, m = 1), on
    the inputs a fused run gives it: program A (unique counting,
    ``_unique_program`` on the feeder's buffer), B (``_fused_partitions``),
    C (``_runs_eval`` at the fused base offsets, with the match masks),
    D (``_fused_labels`` over them and the host's extra edges),
    ``_runs_eval`` at the device runs engine's depth, and
    ``unique_words_device`` whole (upload and read-back included).  For
    each: kernels launched (``torch.profiler``), ms by CUDA events, and the
    bound of :func:`program_bound`; for unique counting also
    ``torch.unique(dim=0)`` on the same rows (the library call; it gives
    no first occurrences)."""
    import math

    import torch

    from humid_tpu_torch.ops import fused as F
    from humid_tpu_torch.ops import runs_device as RD
    from humid_tpu_torch.ops.unique import _unique_program, unique_words_device

    packed = sample_reads(n_reads, seed=5)
    n, w = packed.shape
    feeder = F.DeviceFeeder(w, n, device=device)
    feeder.push(packed)
    fp = F.FusedPipeline(feeder, n, np.zeros(n, bool), word_length=24,
                         max_dist=1, want_inverse=True, want_labels=True)
    k = fp.unique()
    info = {}
    fp.neighbors(info=info)
    buf = feeder.buf
    u_pad = -(-k // 32) * 32
    table = fp._uniq[:u_pad]
    seg_np = RD.segment_lane_masks(24, 2, w)
    seg = torch.from_numpy(seg_np.view(np.int32)).to(device)
    d_base = 2
    ea, eb = (torch.from_numpy(x).to(device) for x in fp._extra)
    rd_info = {}
    RD.runs_device_pairs(fp.table(), 1, word_length=24, device=device,
                         info=rd_info)
    d_rd = rd_info["d_max"]
    log2 = lambda x: max(1, math.ceil(math.log2(max(x, 2))))
    plane = -(-w // 2)
    sweep_ops = lambda nd: 2 * nd * u_pad * (5 * w + plane + 3)
    programs = {
        "A_unique": (lambda: _unique_program(buf, n, True),
                     2 * buf.numel() * 4 + 3 * n * 8,
                     n * log2(n) * plane),
        "B_partitions": (lambda: F._fused_partitions(
            table, k, seg_np, d_cap=8, run_cap=2048),
            table.numel() * 4 + u_pad * 8 + 2 * u_pad // 8 + 12 * 8,
            u_pad * log2(u_pad)),
        "C_sweep_base": (lambda: RD._runs_eval(
            table, fp._orders, seg, k, 1, d_hi=d_base, with_matches=True),
            table.numel() * 4 + u_pad * 8 + 2 * d_base * u_pad * (1 + 1 / 8),
            sweep_ops(d_base)),
        "D_labels": (lambda: F._fused_labels(fp._matches, fp._orders, ea, eb),
                     fp._matches.numel() + u_pad * 8 + 16 * len(ea)
                     + u_pad * 8,
                     6 * fp._matches.numel()),
        f"runs_eval_d{d_rd}": (lambda: RD._runs_eval(
            table, fp._orders, seg, k, 1, d_hi=d_rd),
            table.numel() * 4 + u_pad * 8 + 2 * d_rd * u_pad // 8,
            sweep_ops(d_rd)),
        "unique_words_device": (lambda: unique_words_device(
            packed, False, device=device),
            2 * n * w * 4 + 2 * k * 8, n * log2(n) * plane),
    }
    lanes = buf[:n]
    library = {"A_unique": lambda: torch.unique(
        lanes, dim=0, return_inverse=True, return_counts=True),
        "unique_words_device": lambda: torch.unique(
            torch.from_numpy(packed.view(np.int32)).to(device), dim=0,
            return_counts=True)}
    out = {}
    for name, (fn, n_bytes, ops) in programs.items():
        rec = {"launches": kernels_launched(fn, name),
               "ms": time_cuda(fn, 10), **program_bound(int(n_bytes),
                                                        int(ops), card)}
        rec["library_ms"] = (time_cuda(library[name], 5) if name in library
                             else None)
        out[name] = rec
        say(f"phase 15 program {name}: {json.dumps(rec)}")
    out["shape"] = {"reads": n, "uniques": k, "u_pad": u_pad,
                    "fused": info, "runs_device_d_max": d_rd,
                    "extra_edges": len(ea)}
    say(f"phase 15 shape: {json.dumps(out['shape'])}")
    return out


def write_low_entropy_reads(path: str, n_reads: int, seed: int) -> None:
    """Phase 4's recipe, with 5,000 pool sequences (of n_reads / 8) sharing
    their first 12 bases: at -n 24 -m 1 their words form one run of some
    6,000 rows in the first pigeonhole partition, past ``run_cap``."""
    from humid_tpu_torch.tools.bench import write_fastq

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pool = bases[rng.integers(0, 4, size=(n_reads // 8, 100))]
    pool[:5000, :12] = pool[0, :12]
    seqs = pool[rng.integers(0, len(pool), n_reads)].copy()
    mut = np.flatnonzero(rng.random(n_reads) < 0.3)
    seqs[mut, rng.integers(0, 100, len(mut))] = bases[
        rng.integers(0, 4, len(mut))]
    write_fastq(path, seqs)


def routes_phase(e2e: dict, device: str = "cuda",
                 low_entropy_reads: int = 400_000) -> dict:
    """Phase 16: the phase-4 file through every route of run() (forced
    fused, host runs, device runs, bucketed, and -x through the fused
    device labels), then a low-entropy file whose big runs take
    _big_run_pairs through the tile sweep (default route, host runs,
    forced fused; at least one tile sweep launch each).  Every output
    byte-identical to baseline/humid_ref with the same flags (phase 4's
    outputs where humid_ref is missing)."""
    import humid_tpu_torch
    from humid_tpu_torch.ops import cuda_hamming

    def ref_outputs(fq, name, flags):
        if not e2e["humid_ref"]:
            return None
        out_ref = os.path.join(WORK, f"out_ref_{name}")
        os.makedirs(out_ref)
        subprocess.run([e2e["humid_ref"], *flags, "-d", out_ref, "-l",
                        os.devnull, fq], check=True, capture_output=True)
        return out_ref

    def one(name, fq, refs, *, env=None, opts=None, maximum=False,
            want=None):
        cuda_hamming.LAUNCHES = 0
        t0 = time.perf_counter()
        res = _with_env(env or {}, lambda: humid_tpu_torch.run(
            [fq], word_length=24, distance=1, maximum=maximum,
            dir_name=os.path.join(WORK, f"out_route_{name}"),
            log_name=os.devnull, run_stats=True, write_annotated=True,
            device=device, neighbor_opts=opts))
        seconds = time.perf_counter() - t0
        launches = cuda_hamming.LAUNCHES
        engine = res.extra["engine"]
        check_launches(f"phase 16 {name}", engine, launches)
        if want and any(engine.get(k) != v for k, v in want.items()):
            raise SmokeFailure(f"phase 16 {name}: engine {engine}, wanted "
                               f"{want}")
        for ref in refs:
            if ref:
                _same_files(ref, os.path.join(WORK, f"out_route_{name}"))
        rec = {"seconds": seconds, "launches": launches, "engine": engine,
               "timings": res.extra["timings"]}
        say(f"phase 16 {name}: {json.dumps(rec)}")
        return rec

    fq = e2e["fastq"]
    refs = e2e["outs"]
    fused = {"HUMID_TPU_TORCH_FUSED": "1"}
    out = {"default": {"seconds": e2e["seconds"], "engine": e2e["engine"],
                       "launches": e2e["launches"],
                       "timings": e2e["timings"]}}
    out["fused"] = one("fused", fq, refs, env=fused,
                       want={"strategy": "fused", "fused_fallback": 0})
    for strategy in ("runs", "runs_device", "bucketed"):
        out[strategy] = one(strategy, fq, refs, opts={"strategy": strategy},
                            want={"strategy": strategy})
    ref_x = ref_outputs(fq, "x", [*e2e["flags"], "-x"])
    out["fused_x"] = one("fused_x", fq, [ref_x], env=fused, maximum=True,
                         want={"strategy": "fused", "fused_fallback": 0,
                               "components": "fused"})
    low = os.path.join(WORK, "low_entropy.fastq")
    write_low_entropy_reads(low, low_entropy_reads, seed=16)
    ref_low = ref_outputs(low, "low", e2e["flags"])
    for name, env, opts in (("big_runs_default", None, None),
                            ("big_runs_runs", None, {"strategy": "runs"}),
                            ("big_runs_fused", fused, None)):
        rec = out[name] = one(name, low, [ref_low], env=env, opts=opts)
        if rec["launches"] < 1 or rec["engine"].get("dense_fallbacks"):
            raise SmokeFailure(f"phase 16 {name}: the big runs did not go "
                               f"through the tile sweep: {rec}")
    say("phase 16: every route byte-identical to "
        + ("baseline/humid_ref" if e2e["humid_ref"] else "phase 4's outputs"))
    return out


#: Runs the CLI's ``main`` in a process of a multi-process run and prints
#: one line "MP {json}" after it: the process's kernel launch counts (the
#: counters start at 0 with the process and are read just after the run),
#: the neighbour search's record and the scaling report.
MP_RUNNER = """
import json, sys, time
from humid_tpu_torch import cli
from humid_tpu_torch.ops import cuda_hamming as K
from humid_tpu_torch.parallel import cuda_ring as R
from humid_tpu_torch.parallel import pipeline as PP
t0 = time.perf_counter()
rc = cli.main(sys.argv[1:])
print("MP " + json.dumps({"rc": rc, "k1": K.LAUNCHES, "k2": R.LAUNCHES,
                          "seconds": time.perf_counter() - t0,
                          "engine": PP.LAST_ENGINE,
                          "report": PP.LAST_SCALING_REPORT}), flush=True)
sys.exit(rc)
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read_out(path: str) -> bytes:
    import gzip

    with (gzip.open(path) if path.endswith(".gz") else open(path, "rb")) as f:
        return f.read()


def _same_contents(d1: str, d2: str) -> None:
    """Like _same_files, but gzip files by their decompressed bytes (the
    writers' member boundaries differ)."""
    n1, n2 = sorted(os.listdir(d1)), sorted(os.listdir(d2))
    if n1 != n2:
        raise SmokeFailure(f"output files differ: {n1} vs {n2}")
    for n in n1:
        if _read_out(os.path.join(d1, n)) != _read_out(os.path.join(d2, n)):
            raise SmokeFailure(f"{n} differs between {d1} and {d2}")


def mp_run(name: str, files, flags, n_proc: int, env=None,
           timeout: int = 600) -> dict:
    """The CLI as ``n_proc`` processes of one gloo group on this machine's
    card (a free localhost port), every process started at once; returns
    each process's "MP" record and the wall seconds of the slowest."""
    out = os.path.join(WORK, f"out_{name}")
    port = _free_port()
    env = dict(os.environ, HUMID_TPU_TORCH_DEVICE="cuda",
               HUMID_TPU_TORCH_SCALING_REPORT="1", **(env or {}))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MP_RUNNER, "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", str(n_proc),
         "--process-id", str(p), *flags, "-d", out, "-l",
         os.path.join(WORK, f"{name}_{p}.log"), *files],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for p in range(n_proc)]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    seconds = time.perf_counter() - t0
    recs = []
    for i, (p, (stdout, stderr)) in enumerate(zip(procs, results)):
        if p.returncode:
            raise SmokeFailure(f"{name}: process {i} exited "
                               f"{p.returncode}:\n{stderr[-3000:]}")
        line = [ln for ln in stdout.splitlines() if ln.startswith("MP ")]
        recs.append(json.loads(line[-1][3:]))
    for i, rec in enumerate(recs):
        say(f"{name} process {i}: K1 launches {rec['k1']}, K2 launches "
            f"{rec['k2']}, {rec['seconds']:.3f} s, engine "
            f"{json.dumps(rec['engine'])}")
    say(f"{name} scaling report (process 0): "
        f"{json.dumps(recs[0]['report'])}")
    return {"out": out, "procs": recs, "seconds": seconds,
            "k1": sum(r["k1"] for r in recs),
            "k2": sum(r["k2"] for r in recs),
            "engine": recs[0]["engine"]}


def mp_1m_phase(e2e: dict, device) -> dict:
    """Phase 17 (mp_1M): the phase-4 file as 4 processes on the one card,
    with the sharded cluster phase forced; the neighbour search must run
    on the card (the broadcast pick, or a forced device engine)."""
    from humid_tpu_torch import _backend

    env = {"HUMID_TPU_TORCH_CLUSTER_SHARDED": "1"}
    pick = _backend.pick_neighbor_engine(device, e2e["uniques"],
                                         shardable_only=True)
    if pick == "runs":
        env["HUMID_TPU_TORCH_DEVICE_ENGINE"] = "1"
    rec = mp_run("mp_1M", [e2e["fastq"]], e2e["flags"], 4, env)
    engine = rec["engine"]
    if engine.get("strategy") not in ("bucketed", "runs_device", "dense"):
        raise SmokeFailure(f"mp_1M searched the neighbours with "
                           f"{engine}, not a device engine")
    if engine.get("cluster") != "sharded":
        raise SmokeFailure(f"mp_1M: cluster phase {engine.get('cluster')}")
    for ref in e2e["outs"]:
        _same_files(ref, rec["out"])
    say(f"phase 17 mp_1M: 4 processes, {rec['seconds']:.3f} s wall, router "
        f"pick {pick}{' (forced to a device engine)' if pick == 'runs' else ''}"
        f"; outputs byte-identical to phase 4's"
        + (" and to baseline/humid_ref" if len(e2e["outs"]) > 1 else ""))
    return rec


def mp_big_runs_phase() -> dict:
    """Phase 18 (mp_big_runs): phase 16's low-entropy file as 4 processes,
    the cluster gate at its default: byte-identical to phase 16's default
    run, and the owned big run through K1 in some process."""
    low = os.path.join(WORK, "low_entropy.fastq")
    rec = mp_run("mp_big_runs", [low], ["-n", "24", "-m", "1", "-s", "-a"],
                 4)
    for ref in ("out_route_big_runs_default", "out_ref_low"):
        if os.path.isdir(os.path.join(WORK, ref)):
            _same_files(os.path.join(WORK, ref), rec["out"])
    if rec["k1"] < 1:
        raise SmokeFailure(f"mp_big_runs: no process launched K1: {rec}")
    if rec["engine"].get("cluster") != "replicated":
        raise SmokeFailure(f"mp_big_runs: cluster {rec['engine']}")
    say(f"phase 18 mp_big_runs: K1 launches over the processes "
        f"{[r['k1'] for r in rec['procs']]}; byte-identical to phase 16")
    return rec


def mp_edit_gz_phase(e2e: dict, device: str = "cuda",
                     n_reads: int = 200_000) -> dict:
    """Phase 19 (mp_edit, mp_gz): a 200,000-read file of the benchmark
    recipe with -e as 2 processes, and its gzip copy (Hamming, phase 4's
    flags) as 3 processes through the range spill; each against the
    single-process port in process and baseline/humid_ref."""
    import gzip

    import humid_tpu_torch
    from humid_tpu_torch.tools.bench import gen_dataset

    fq = os.path.join(WORK, "sample_200k.fastq")
    gen_dataset(fq, n_reads, seed=19)
    fq_gz = fq + ".gz"
    with open(fq, "rb") as src, gzip.open(fq_gz, "wb", compresslevel=1) as g:
        shutil.copyfileobj(src, g, 1 << 24)
    out = {}
    for name, path, flags, n_proc in (
            ("mp_edit", fq, ["-n", "24", "-m", "1", "-e", "-s", "-a"], 2),
            ("mp_gz", fq_gz, e2e["flags"], 3)):
        one = os.path.join(WORK, f"out_{name}_one")
        t0 = time.perf_counter()
        humid_tpu_torch.run([path], word_length=24, distance=1,
                            edit="-e" in flags, dir_name=one,
                            log_name=os.devnull, run_stats=True,
                            write_annotated=True, device=device)
        one_s = time.perf_counter() - t0
        rec = mp_run(name, [path], flags, n_proc)
        refs = [one]
        if e2e["humid_ref"]:
            ref = os.path.join(WORK, f"out_ref_{name}")
            os.makedirs(ref)
            subprocess.run([e2e["humid_ref"], *flags, "-d", ref, "-l",
                            os.devnull, path], check=True,
                           capture_output=True)
            refs.append(ref)
        for ref in refs:
            _same_contents(ref, rec["out"])
        say(f"phase 19 {name}: {n_proc} processes {rec['seconds']:.3f} s "
            f"wall against one process in process {one_s:.3f} s; "
            f"{'decompressed ' if path.endswith('.gz') else ''}outputs "
            f"identical to the single-process port"
            + (" and to baseline/humid_ref" if e2e["humid_ref"] else ""))
        out[name] = rec
    return out


def mesh_labels_phase(e2e: dict, device, card) -> dict:
    """Phase 20 (mesh_labels): e2e_1M's unique table and its bucketed K1
    pairs; ``distributed_components`` replicated (its default) and
    node-sharded on 4 shards of the card, and ``dedup_step`` on 4 shards,
    each label for label against the single-card
    ``connected_components_device``; ms by CUDA events, kernels and busy
    time from ``torch.profiler``, the bound of ``program_bound``.  The
    shards' streams overlap K2's launches, so busy is the union of the
    kernels' intervals, and it is kept only when the trace holds every
    K2 launch that the wrapper counted."""
    import torch

    from humid_tpu_torch.cluster.labelprop import components_tensor
    from humid_tpu_torch.ops import find_neighbor_pairs, unique_words
    from humid_tpu_torch.parallel import cuda_ring, data_mesh
    from humid_tpu_torch.parallel import labelprop as L
    from humid_tpu_torch.parallel.pipeline import pack_host_range

    packed, filtered = pack_host_range([e2e["fastq"]], 0, 1 << 40)
    uniq = unique_words(packed[~filtered], want_inverse=False,
                        device=device)[0]
    u = len(uniq)
    pa, pb = find_neighbor_pairs(uniq, 1, word_length=24,
                                 strategy="bucketed", device=device)
    want = components_tensor(pa, pb, u, device).cpu().numpy()
    mesh = data_mesh(4, device)
    e = len(pa)
    labels_bound = program_bound(16 * e + 8 * u, 4 * e + 2 * u, card)
    programs = {
        "labels_replicated": lambda: L.distributed_components(
            pa, pb, u, mesh=mesh, node_sharded=False),
        "labels_node_sharded": lambda: L.distributed_components(
            pa, pb, u, mesh=mesh, node_sharded=True),
        "dedup_step": lambda: L.dedup_step(uniq, 1, mesh=mesh)[0],
        "single_card": lambda: components_tensor(pa, pb, u, device),
    }
    out = {"nodes": u, "edges": e}
    for name, fn in programs.items():
        if name == "dedup_step":
            cuda_ring.LAUNCHES = 0
            got = fn()
            out["k2_launches"] = cuda_ring.LAUNCHES
            if out["k2_launches"] < 1:
                raise SmokeFailure("mesh_labels: dedup_step launched no K2")
        else:
            got = fn()
        got = got.cpu().numpy() if hasattr(got, "cpu") else got
        if not np.array_equal(got, want):
            raise SmokeFailure(f"mesh_labels {name}: labels differ from "
                               f"connected_components_device")
        bound = labels_bound
        if name == "dedup_step":
            # K2's ring meets every word pair once: the bound of the form
            # it runs (the simplex int8 tensor-core form) for those
            # evaluations (the labels' share is far below it).
            bound = simplex_bound(u * (u - 1) // 2, uniq.shape[1],
                             4 * uniq.size + 16 * e + 8 * u)
        rec = {"launches": kernels_launched(
                   fn, name, "ring_sweep_kernel" if name == "dedup_step"
                   else None),
               "ms": time_cuda(fn, 3), **bound}
        if (name == "dedup_step"
                and rec["launches"]["named"] != out["k2_launches"]):
            # The trace lost K2 events: its busy time would be short.
            rec["launches"]["busy_ms"] = None
        out[name] = rec
        say(f"phase 20 {name}: labels equal; {json.dumps(rec)}")
    say(f"phase 20 mesh_labels: {u} nodes, {e} edges, "
        f"{len(np.unique(want))} components; K2 launches in dedup_step "
        f"{out['k2_launches']}")
    return out


STARTUP_PROBE = """
import json, time
t = [time.perf_counter()]
import torch
t.append(time.perf_counter())
import humid_tpu_torch.cli
t.append(time.perf_counter())
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t.append(time.perf_counter())
from humid_tpu_torch import _build
for name in ("hamming_sweep", "ring_sweep"):
    _build.build(name)
t.append(time.perf_counter())
from humid_tpu_torch import _backend
_backend.engine_constants(torch.device("cuda"))
t.append(time.perf_counter())
parts = ["torch_import", "package_import", "cuda_init", "build_check",
         "calibration_read"]
print(json.dumps({k: b - a for k, a, b in zip(parts, t, t[1:])}))
"""


def startup_phase() -> dict:
    """Phase 21 (startup): one subprocess like the CLI's, its start-up cut
    into the torch import, the package import, CUDA init, _build.py's
    staleness check of both kernels and the calibration cache read."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", STARTUP_PROBE], cwd=REPO,
                          capture_output=True, text=True)
    if proc.returncode:
        raise SmokeFailure(f"startup probe failed:\n{proc.stderr}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    rec["process_s"] = time.perf_counter() - t0
    say(f"phase 21 startup (s): {json.dumps(rec)}")
    return rec


def _run_e2e(e2e: dict, name: str, device, **kw):
    """The phase-4 file through ``run()`` with phase 4's flags into
    build/chip_smoke/out_<name>; returns (result, seconds, K1 launches)."""
    import humid_tpu_torch
    from humid_tpu_torch.ops import cuda_hamming

    cuda_hamming.LAUNCHES = 0
    t0 = time.perf_counter()
    res = humid_tpu_torch.run(
        [kw.pop("fastq", e2e["fastq"])], word_length=24, distance=1,
        dir_name=os.path.join(WORK, f"out_{name}"), log_name=os.devnull,
        run_stats=True, write_annotated=True, device=device, **kw)
    return res, time.perf_counter() - t0, cuda_hamming.LAUNCHES


DIRECTIONAL = "Calculating directional clusters"


def directional_device_phase(e2e: dict, device, card) -> dict:
    """Phase 22 (directional_1M): e2e_1M's unique table and its bucketed
    K1 pairs (K1 launches counted) clustered by
    ``cluster_directional_device`` on the card, against the host walk and
    the same function on the CPU, field for field; the round program's ms
    by CUDA events, its kernels and busy time from ``torch.profiler`` and
    ``program_bound``; a 40-node doubling chain on the card against the
    host walk; then e2e_1M with HUMID_TPU_TORCH_CLUSTER=device against
    phase 4's outputs and baseline/humid_ref."""
    import torch

    from humid_tpu_torch._device import to_device
    from humid_tpu_torch.cluster import cluster_exact
    from humid_tpu_torch.cluster import directional_device as D
    from humid_tpu_torch.cluster.labelprop import components_tensor
    from humid_tpu_torch.ops import (cuda_hamming, find_neighbor_pairs,
                                     pairs_to_csr, unique_words)
    from humid_tpu_torch.parallel.pipeline import pack_host_range

    packed, filtered = pack_host_range([e2e["fastq"]], 0, 1 << 40)
    uniq, counts, _, _ = unique_words(packed[~filtered], want_inverse=False,
                                      device=device)
    u = len(uniq)
    cuda_hamming.LAUNCHES = 0
    pa, pb = find_neighbor_pairs(uniq, 1, word_length=24,
                                 strategy="bucketed", device=device)
    out = {"nodes": u, "edges": len(pa), "k1": cuda_hamming.LAUNCHES}
    if out["k1"] < 1:
        raise SmokeFailure("phase 22: the bucketed pairs launched no K1")
    indptr, indices = pairs_to_csr(pa, pb, u)
    t0 = time.perf_counter()
    host = cluster_exact(counts, indptr, indices)
    out["host_walk_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = D.cluster_directional_device(counts, pa, pb, device="cpu")
    out["cpu_s"] = time.perf_counter() - t0
    info = {}
    got, out["card_ms"] = _timed(lambda: D.cluster_directional_device(
        counts, pa, pb, device=device, info=info))
    out["rounds"] = info["rounds"]
    for field in ("labels", "max_leaf", "max_count", "size"):
        for name, want in (("host walk", host), ("CPU", on_cpu)):
            if not np.array_equal(getattr(got, field), getattr(want, field)):
                raise SmokeFailure(f"phase 22: {field} on the card differs "
                                   f"from the {name}")
    out["clusters"] = got.num_clusters

    # The round program alone, on inputs already on the card.
    comp = components_tensor(pa, pb, u, device)
    args = [to_device(np.ascontiguousarray(x, np.int64), device)
            for x in (counts, pa, pb)]
    rounds_fn = lambda: D._directional_rounds(args[0], comp, args[1],
                                              args[2])
    e = len(pa)
    # Inputs read once (counts, comp, both edge arrays), two [u] outputs;
    # per round about 6 integer operations per directed edge in each of
    # the 31 climb sweeps and 31 descent sweeps.
    bound = program_bound(8 * (4 * u + 2 * e),
                          out["rounds"] * 62 * 6 * 2 * e, card)
    out["program"] = {"launches": kernels_launched(rounds_fn,
                                                   "directional_rounds"),
                      "ms": time_cuda(rounds_fn, 3), **bound}

    chain = 1 << (np.arange(40, dtype=np.int64) % 20)
    ca = np.arange(39, dtype=np.int64)
    ip, ix = pairs_to_csr(ca, ca + 1, 40)
    want = cluster_exact(chain, ip, ix)
    chain_got = D.cluster_directional_device(chain, ca, ca + 1,
                                             device=device)
    if not (np.array_equal(chain_got.labels, want.labels)
            and np.array_equal(chain_got.max_leaf, want.max_leaf)):
        raise SmokeFailure("phase 22: the doubling chain differs")

    res, seconds, launches = _with_env(
        {"HUMID_TPU_TORCH_CLUSTER": "device"},
        lambda: _run_e2e(e2e, "directional_device", device))
    if res.extra["engine"].get("directional") != "device":
        raise SmokeFailure(f"phase 22: e2e engine {res.extra['engine']}")
    for ref in e2e["outs"]:
        _same_files(ref, os.path.join(WORK, "out_directional_device"))
    out["e2e"] = {"seconds": seconds, "k1": launches,
                  "engine": res.extra["engine"],
                  "directional_s": res.extra["timings"][DIRECTIONAL],
                  "default_directional_s": e2e["timings"][DIRECTIONAL]}
    say(f"phase 22 directional_1M: {json.dumps(out)}; the card == the host "
        f"walk == the CPU; the doubling chain equal; e2e outputs "
        f"byte-identical to phase 4's"
        + (" and to baseline/humid_ref" if e2e["humid_ref"] else ""))
    return out


def _trace_summary(profile_dir: str) -> dict:
    """The one Chrome trace in ``profile_dir``: its CUDA kernel events and
    whether the phases' ranges are in it."""
    names = os.listdir(profile_dir)
    if len(names) != 1:
        raise SmokeFailure(f"profile dir holds {names}, not one trace")
    with open(os.path.join(profile_dir, names[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    phases = ("Reading data", "Calculating neighbours using Hamming "
              "distance", DIRECTIONAL)
    present = {e.get("name") for e in events}
    return {"events": len(events), "kernel_events": len(kernels),
            "kernel_ms": sum(e.get("dur", 0) for e in kernels) / 1e3,
            "phases": [p for p in phases if p in present],
            "missing_phases": [p for p in phases if p not in present]}


def profile_phase(e2e: dict, device) -> dict:
    """Phase 23: e2e_1M with ``profile_dir=``: one trace that parses and
    holds CUDA kernel events and the three phase ranges, outputs equal to
    phase 4's."""
    out = {}
    for attempt in (1, 2):  # once more if the trace lost every kernel
        prof = os.path.join(WORK, f"profile_{attempt}")
        res, seconds, _ = _run_e2e(e2e, "profiled", device,
                                   profile_dir=prof)
        _same_files(os.path.join(WORK, "out_run"),
                    os.path.join(WORK, "out_profiled"))
        trace = _trace_summary(prof)
        if trace["kernel_events"]:
            break
        shutil.rmtree(os.path.join(WORK, "out_profiled"))
    if trace["kernel_events"] < 1 or trace["missing_phases"]:
        raise SmokeFailure(f"phase 23 profiler: {trace}")
    out["profiled"] = {"seconds": seconds, "trace": trace,
                       "attempts": attempt, "timings": res.extra["timings"]}
    say(f"phase 23: {json.dumps(out)}; outputs byte-identical to phase 4's")
    return out


#: One run of the phase-4 file by the copy with the host extensions built
#: (argv: fastq, output dir); prints "EXT {json}" after it.
EXT_RUNNER = """
import importlib, json, sys, time
import humid_tpu_torch
from humid_tpu_torch import _backend
errors = {}
for name in ("_hostops", "cluster._ccluster", "io._cfastqio"):
    try:
        importlib.import_module("humid_tpu_torch." + name)
    except ImportError as exc:
        errors[name] = str(exc)
t0 = time.perf_counter()
res = humid_tpu_torch.run([sys.argv[1]], word_length=24, distance=1,
                          dir_name=sys.argv[2], log_name="/dev/null",
                          run_stats=True, write_annotated=True)
print("EXT " + json.dumps({
    "seconds": time.perf_counter() - t0, "engine": res.extra["engine"],
    "timings": res.extra["timings"],
    "extensions": _backend._host_extensions(), "import_errors": errors}),
    flush=True)
"""


def _ext_toolchain_missing() -> str | None:
    """Why setup.py cannot build here (no compiler, no Python headers), or
    None."""
    import sysconfig

    cc = (sysconfig.get_config_var("CC") or "cc").split()[0]
    if shutil.which(cc) is None:
        return f"no C compiler ({cc})"
    header = os.path.join(sysconfig.get_paths()["include"], "Python.h")
    if not os.path.exists(header):
        return f"no Python headers ({header})"
    return None


def _build_ext(tree: str, env: dict | None = None
               ) -> subprocess.CompletedProcess:
    # Serial: the two packages' extensions compile the same sources to the
    # same object files, which a parallel build (-j) writes concurrently.
    return subprocess.run(
        [sys.executable, "setup.py", "build_ext", "--inplace", "--force"],
        cwd=tree, capture_output=True, text=True, env=env)


def host_extensions_phase(e2e: dict, device: str = "cuda") -> dict | None:
    """Phase 24: humid_tpu_torch/, csrc/ and setup.py copied to
    build/chip_smoke/ext_tree/, ``setup.py build_ext --inplace`` there,
    then the phase-4 file by two subprocesses from that copy (its own
    calibration file): the default route and HUMID_TPU_TORCH_CLUSTER=device;
    each byte-identical to baseline/humid_ref (phase 4's outputs without it).
    The build takes the first compiler pair that links -fopenmp
    (``check_native.openmp_toolchain``: $CC/$CXX, the path's, then
    /usr/bin's), passed to setup.py as CC and CXX; only where no pair can
    link it is the copy built without OpenMP (said on its own line, with
    the reason).  Without a compiler or Python headers the phase says so
    and returns None; any other failure fails the run."""
    from humid_tpu_torch.tools.check_native import openmp_toolchain

    why = _ext_toolchain_missing()
    if why:
        say(f"phase 24 host extensions: not built, {why}")
        return None
    tree = os.path.join(WORK, "ext_tree")
    for part in ("humid_tpu_torch", "csrc"):
        shutil.copytree(os.path.join(REPO, part), os.path.join(tree, part),
                        ignore=shutil.ignore_patterns("*.so", "__pycache__"))
    shutil.copy2(os.path.join(REPO, "setup.py"), tree)
    # The kernels built in phase 2 (newer than their copied sources).
    built = os.path.join(REPO, "build", "humid_tpu_torch")
    if os.path.isdir(built):
        shutil.copytree(built, os.path.join(tree, "build", "humid_tpu_torch"))
    # setup.py builds the JAX package's extensions too: give them their
    # directories (the copy holds no JAX package).
    for d in ("cluster", "io"):
        os.makedirs(os.path.join(tree, "humid_tpu", d))
    t0 = time.perf_counter()
    pair = openmp_toolchain()
    openmp = pair is not None
    if pair is None:
        # No compiler with its OpenMP runtime: the sources build without
        # OpenMP (every OpenMP use is guarded), their loops then serial.
        say("phase 24 host extensions: openmp: false; no compiler pair "
            "($CC/$CXX, gcc/g++ on the path, /usr/bin) links -fopenmp; "
            "building the copy without OpenMP")
        with open(os.path.join(tree, "setup.py")) as f:
            recipe = f.read()
        with open(os.path.join(tree, "setup.py"), "w") as f:
            f.write(re.sub(r',?\s*"-fopenmp"', "", recipe))
        proc = _build_ext(tree)
    else:
        proc = _build_ext(tree, dict(os.environ, CC=pair["cc"],
                                     CXX=pair["cxx"]))
    build_s = time.perf_counter() - t0
    if proc.returncode:
        raise SmokeFailure(f"phase 24: setup.py build_ext failed:\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    env = dict(os.environ, PYTHONPATH=tree, HUMID_TPU_TORCH_DEVICE=device,
               HUMID_TPU_TORCH_CALIB_PATH=os.path.join(tree, "calib.json"))
    env.pop("HUMID_TPU_TORCH_CLUSTER", None)
    out = {"build_s": build_s, "openmp": openmp, "compiler": pair,
           "tree": tree, "env": env}
    for name, extra in (("default", {}),
                        ("cluster_device", {"HUMID_TPU_TORCH_CLUSTER":
                                            "device"})):
        dest = os.path.join(WORK, f"out_ext_{name}")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", EXT_RUNNER, e2e["fastq"], dest],
            cwd=tree, env={**env, **extra}, capture_output=True, text=True)
        if proc.returncode:
            raise SmokeFailure(f"phase 24 {name} failed:\n{proc.stderr}")
        rec = json.loads([ln for ln in proc.stdout.splitlines()
                          if ln.startswith("EXT ")][-1][4:])
        rec["process_s"] = time.perf_counter() - t0
        if rec["extensions"] != "111":
            raise SmokeFailure(f"phase 24 {name}: extensions "
                               f"{rec['extensions']} loaded, not all three: "
                               f"{rec['import_errors']}")
        if (name == "cluster_device"
                and rec["engine"].get("directional") != "device"):
            raise SmokeFailure(f"phase 24 cluster_device: {rec['engine']}")
        _same_files(e2e["outs"][-1], dest)
        out[name] = rec
        say(f"phase 24 {name}: {json.dumps(rec)}")
    say(f"phase 24 host extensions: built in {build_s:.3f} s, openmp: "
        f"{json.dumps(openmp)} (compiler pair {json.dumps(pair)}); both "
        f"routes byte-identical to "
        + ("baseline/humid_ref" if e2e["humid_ref"] else "phase 4's outputs"))
    return out


BENCH_READS = 1_000_000


def bench_phase(ext: dict | None, card: str, device: str = "cuda") -> int:
    """Phase 27 (bench_1M): ``python -m humid_tpu_torch.tools.bench`` at
    1,000,000 reads, distance 1, as a subprocess (a) from phase 24's
    extension tree, with its calibration file and kernel builds, and (b)
    from the checkout, where the numpy fallbacks run.  Both share one
    dataset cache (TMPDIR under build/chip_smoke).  Each JSON line must say
    ``backend`` cuda, carry the card, list the tree's host extensions and
    a measured humid_ref baseline, and the bench's dedup file must equal
    the one humid_ref wrote in the same run.  Then the bench's dataset
    once in process through ``run()`` with the bench's flags: the kernels
    of its traced run; returns its K1 launches (``bench_1M``).  Without
    phase 24's tree (``ext`` None) only (b) runs."""
    import humid_tpu_torch
    from humid_tpu_torch.ops import cuda_hamming
    from humid_tpu_torch.tools.bench import EXTENSIONS

    tmp = os.path.join(WORK, "tmp")
    os.makedirs(tmp, exist_ok=True)
    bench_dir = os.path.join(tmp, "humid_tpu_torch_bench")
    base = dict(os.environ, TMPDIR=tmp, HUMID_TPU_TORCH_DEVICE=device)
    runs = []
    if ext is None:
        say("phase 27 bench: no extension tree (phase 24 could not build "
            "the host extensions); the checkout's run only")
    else:
        # The bench builds baseline/humid_ref beside its package.
        os.makedirs(os.path.join(ext["tree"], "baseline"), exist_ok=True)
        shutil.copy2(os.path.join(REPO, "baseline", "humid_ref.cpp"),
                     os.path.join(ext["tree"], "baseline"))
        runs.append(("extensions", ext["tree"], {**ext["env"], "TMPDIR": tmp},
                     True))
    runs.append(("numpy_fallbacks", REPO, base, False))
    for name, cwd, env, built in runs:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "humid_tpu_torch.tools.bench",
             "--reads", str(BENCH_READS), "--distance", "1"],
            cwd=cwd, env=env, capture_output=True, text=True, timeout=900)
        seconds = time.perf_counter() - t0
        if proc.returncode:
            raise SmokeFailure(f"phase 27 {name}: the bench failed:\n"
                               f"{proc.stderr[-4000:]}")
        line = proc.stdout.strip().splitlines()[-1]
        rec = json.loads(line)
        want_ext = {n: built for n in EXTENSIONS}
        problems = [what for what, ok in (
            ("backend", rec["backend"] == device),
            ("card", bool(rec["card"])),
            ("host_extensions", rec["host_extensions"] == want_ext),
            ("baseline_source", rec["baseline_source"] == "humid_ref"))
            if not ok]
        if problems:
            raise SmokeFailure(f"phase 27 {name}: {problems} wrong in {line}")
        # Compared now: the next run overwrites both directories.
        _same_files(os.path.join(bench_dir, "out"),
                    os.path.join(bench_dir, "out_ref"))
        say(f"phase 27 {name} ({seconds:.3f} s in all; {card}): "
            + json.dumps({"openmp": ext["openmp"] if built else None}))
        say(line)
        for note in proc.stderr.strip().splitlines():
            if note.startswith("#"):
                say(f"phase 27 {name} {note}")
        say(f"phase 27 {name}: dedup output byte-identical to "
            f"baseline/humid_ref's on the same file")

    fq = os.path.join(bench_dir, f"bench_{BENCH_READS}.fastq")
    last = {}

    def bench_run():
        cuda_hamming.LAUNCHES = 0
        res = humid_tpu_torch.run([fq], distance=1, write_dedup=True,
                                  dir_name=os.path.join(WORK, "out_bench"),
                                  log_name=os.devnull, device=device)
        last.update(engine=res.extra["engine"], unique=res.unique,
                    k1=cuda_hamming.LAUNCHES)

    traced = kernels_launched(bench_run, "bench_1M", "hamming_sweep_kernel")
    check_launches("phase 27 bench_1M", last["engine"], last["k1"])
    _same_files(os.path.join(WORK, "out_bench"),
                os.path.join(bench_dir, "out_ref"))
    say(f"phase 27 bench_1M in process: {last['unique']} uniques, engine "
        f"{json.dumps(last['engine'])}, K1 launches {last['k1']}; traced "
        f"{json.dumps(traced)}; dedup output == humid_ref's")
    return last["k1"]


def _tool(name: str, args, timeout: int, env=None):
    """``python -m humid_tpu_torch.tools.<name> args`` from the checkout on
    the card: (return code, stdout, its last line as JSON or None,
    seconds)."""
    t0 = time.perf_counter()
    # Its own process group: a timeout stops the tool's children too.
    proc = subprocess.Popen(
        [sys.executable, "-m", f"humid_tpu_torch.tools.{name}", *args],
        cwd=REPO, env=dict(os.environ, HUMID_TPU_TORCH_DEVICE="cuda",
                           **(env or {})),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        _stop_group(proc)
    seconds = time.perf_counter() - t0
    try:
        last = json.loads(out.strip().splitlines()[-1])
    except (IndexError, ValueError):
        last = None
    if proc.returncode or last is None:
        raise SmokeFailure(f"{name} {' '.join(args)} exited "
                           f"{proc.returncode} after {seconds:.3f} s:\n"
                           f"{out[-6000:]}{err[-4000:]}")
    return out, last, seconds


FUZZ_CONFIGS = 100
MP_CONFIGS = 4


def fuzz_oracle_phase() -> dict:
    """Phase 28: ``python -m humid_tpu_torch.tools.fuzz_oracle`` on the
    card, 100 configs from seed 10,000 on 8 shards, with phase 13's
    calibration file: every config must match the string oracle, and the
    campaign must have launched K1 and K2 (counted in the tool's process,
    which starts at 0)."""
    _, out, seconds = _tool("fuzz_oracle", [str(FUZZ_CONFIGS), "10000",
                                            "--shards", "8"], timeout=900)
    out["process_s"] = seconds
    say(f"phase 28 fuzz_oracle: {json.dumps(out)}")
    if out["failures"] or out["configs"] != FUZZ_CONFIGS:
        raise SmokeFailure(f"phase 28: {out['failures']} configs differ "
                           f"from the oracle: {out['failed_seeds']}")
    short = [k for k, n in out["launches"].items() if n < 1]
    if short:
        raise SmokeFailure(f"phase 28: the campaign launched no {short}")
    say(f"phase 28 fuzz_oracle: {FUZZ_CONFIGS} configs == the string "
        f"oracle; cases per engine {json.dumps(out['engines'])}; launches "
        f"{json.dumps(out['launches'])}; {seconds:.3f} s")
    return out


def fuzz_multiproc_phase() -> dict:
    """Phase 29: ``python -m humid_tpu_torch.tools.fuzz_multiproc`` on the
    card, MP_CONFIGS configs from seed 42,000 (2-3 CLI processes each,
    one gloo group on the one card), each byte-identical to the
    in-process run."""
    text, out, seconds = _tool("fuzz_multiproc", [str(MP_CONFIGS), "42000"],
                               timeout=MP_CONFIGS * 330)
    for line in text.splitlines():
        if line.startswith("["):
            say(f"phase 29 {line}")
    if out["failures"]:
        raise SmokeFailure(f"phase 29: seeds {out['failed_seeds']} differ")
    say(f"phase 29 fuzz_multiproc: {MP_CONFIGS} configs byte-identical to "
        f"the single-process run; seconds per config "
        f"{json.dumps(out['seconds_per_config'])}; {seconds:.3f} s")
    return out


def engine_xover_phase(device, card: str) -> dict:
    """Phase 30: ``engine_xover.measure`` in process at its four default
    sizes (2^18-2^23 uniques) with all six engines, best of 2: every
    engine's pairs equal (tolerance 0; the tool raises otherwise); the
    router's pick among the table engines and its predicted ms beside the
    fastest measured, and its fused decision at the reads' count beside
    the two whole-pipeline engines.  A pick slower than the fastest by
    more than the calibration's spread + 10% is printed as a fault, not
    failed: it is a measurement."""
    from humid_tpu_torch import _backend as B
    from humid_tpu_torch.tools import engine_xover as X

    c = B.engine_constants(device)
    margin = float(c["spread"]) + 0.1
    out = {}
    for u in X.DEFAULT_SIZES:
        gen, lines, _ = X.measure(u, X.TABLE_ENGINES + X.WHOLE_ENGINES,
                                  runs=2, device=device, card=card)
        say(f"phase 30 generator: {json.dumps(gen)}")
        for line in lines:
            say(f"phase 30 {json.dumps(line)}")
        ms = {ln["engine"]: ln["best_s"] * 1e3 for ln in lines}
        table_ms = {e: ms[e] for e in X.TABLE_ENGINES}
        pick = B.pick_neighbor_engine(device, gen["u"])
        fastest = min(table_ms, key=table_ms.get)
        rec = {"u": gen["u"], "n_reads": gen["n_reads"],
               "generator_s": gen["generator_s"], "wall_ms": ms,
               "pairs": lines[0]["pairs"], "pick": pick, "fastest": fastest,
               "predicted_ms": {e: t / 1e6 for e, t in B.neighbor_times_ns(
                   c, gen["u"]).items()},
               "fused_pick": B.use_fused_pipeline(device, gen["n_reads"]),
               "fused_predicted_ms": [t / 1e6 for t in B.fused_times_ns(
                   c, gen["n_reads"])],
               "pick_slower_by": table_ms[pick] / table_ms[fastest] - 1}
        rec["fault"] = rec["pick_slower_by"] > margin
        out[u] = rec
        say(f"phase 30 {u}: all six engines' pairs equal (tolerance 0); "
            f"{json.dumps(rec)}")
        if rec["fault"]:
            say(f"phase 30 FAULT (recorded, not failed): at {gen['u']} "
                f"uniques the router picks {pick} ({table_ms[pick]:.3f} ms), "
                f"slower than {fastest} ({table_ms[fastest]:.3f} ms) by more "
                f"than the spread + 10% ({margin:.3f})")
    return out


def _stop_group(proc) -> None:
    """Kill what is left of ``proc``'s process group; reap ``proc``."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def check_native_start():
    """Phase 31's host half (``check_native --host``, CPU only), started in
    the background in its own process group; :func:`check_native_wait`
    collects it."""
    log = open(os.path.join(WORK, "check_native_host.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "humid_tpu_torch.tools.check_native",
         "--host"], cwd=REPO, stdout=log,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    return proc, log, time.perf_counter()


def check_native_wait(host) -> dict:
    """Phase 31's host half, collected: ASan build, native tests, fuzz
    (or the line that says why it could not run)."""
    proc, log, t0 = host
    try:
        rc = proc.wait(timeout=900)
    finally:
        _stop_group(proc)
    log.seek(0)
    text = log.read()
    log.close()
    for line in text.splitlines()[:-1]:
        if line.startswith("check_native"):
            say(f"phase 31 {line}")
    if rc:
        raise SmokeFailure(f"phase 31 host half exited {rc}:\n"
                           f"{text[-8000:]}")
    rec = json.loads(text.strip().splitlines()[-1])["host"]
    rec["process_s"] = time.perf_counter() - t0
    return rec


def check_native_phase(host: dict) -> dict:
    """Phase 31: ``check_native --device`` (the kernel cases under
    compute-sanitizer's four tools, then the guarded cases on the card)
    beside the host half's result.  Fails on any error either found; a
    sanitizer or a toolchain that cannot run here is said on its own
    line."""
    text, rec, seconds = _tool("check_native", ["--device"], timeout=900)
    for line in text.splitlines()[:-1]:
        say(f"phase 31 {line}")
    dev = rec["device"]
    if dev["errors"]:
        raise SmokeFailure(f"phase 31: compute-sanitizer found errors: "
                           f"{json.dumps(dev['sanitizer'])}")
    tools = {t: r["status"] for t, r in dev["sanitizer"].items()}
    say(f"phase 31 check_native: host half {host['status']} "
        f"({host['process_s']:.3f} s, beside phases 28-29); device half "
        f"{seconds:.3f} s; compute-sanitizer {json.dumps(tools)}; guarded "
        f"cases {json.dumps(dev['guarded_cases'])}; repeat cases (the "
        f"stand-in for racecheck) {json.dumps(dev['repeat_cases'])}")
    if dev["unchecked"]:
        say(f"phase 31 NOT SHOWN: zero errors from compute-sanitizer's "
            f"{', '.join(dev['unchecked'])} on K1 and K2; the tool cannot "
            f"attach to this card, so only the guard checks ran")
    return {"host": host, "device": dev, "device_s": seconds}


def sanitizer_entry(native: dict, kernel: str) -> dict:
    """The kernels line's ``sanitizer`` of one kernel: each
    compute-sanitizer tool's status, whether all four showed zero errors
    (``zero_errors_shown``), and the guarded cases' counts."""
    dev = native["device"]
    tools = {t: r["status"] for t, r in dev["sanitizer"].items()}
    return {**tools, "zero_errors_shown": all(
        v == "0 errors" for v in tools.values()),
        "guarded": dev["guarded_cases"][kernel],
        "repeats": {**dev["repeat_cases"][kernel],
                    "per_case": dev["repeat_cases"]["repeats"]}}


def timed(label, fn, *args):
    """``fn(*args)``, then a line with the phase's seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    say(f"phase {label} seconds: {time.perf_counter() - t0:.3f}")
    return out


def mesh_main(device, smi_lines) -> int:
    """``chip_smoke.py --mesh``: the local-mesh route on every card of the
    machine, against what it must equal, and nothing else: the router's
    calibration (with several cards it measures the bucketed mesh search
    too) and its picks (phase 13); the engines at the sweep tables, the
    mesh among them (phase 14); the ring, both edit mesh searches and
    ``dedup_step`` on one shard a card against the same four shards on
    card 0; e2e_1M by ``auto`` against baseline/humid_ref (phase 4); the
    bucketed mesh search on one shard a card with its K1 intervals (phase
    25), which must show two cards' kernels overlapping at sweep_10M.
    Ends with one line per card from nvidia-smi and the result line."""
    import torch

    from humid_tpu_torch import parallel as P
    from humid_tpu_torch.parallel import labelprop as L
    from humid_tpu_torch.tools.ring_profile import sample_table

    tables = {name: sample_table(n, seed=n % 997) for name, n in (
        ("bucketed_1M_reads", 1_000_000), ("bucketed_10M_reads", 10_000_000))}
    calib = calibration_phase(device, tables)
    _, runs_pairs = engines_agree_phase(device, tables, probe_reads=())
    cards, card0 = P.data_mesh(4, device), P.data_mesh(4, torch.device(
        "cuda", 0))
    uniq = tables["bucketed_1M_reads"]
    edit_table = with_indels(sample_table(72_000, 33, seed=33, n_subst=2),
                             33, 8192, seed=1)
    checks = {
        "ring_1M": lambda m: P.sharded_neighbor_pairs_ring(
            uniq, 1, word_length=24, mesh=m),
        "edit_shifted_8192": lambda m: P.sharded_edit_pairs_shifted(
            edit_table, 2, word_length=33, mesh=m),
        "edit_ring_8192": lambda m: P.sharded_neighbor_pairs(
            edit_table, 2, metric="edit", word_length=33, mesh=m),
        "dedup_step_1M": lambda m: (L.dedup_step(uniq, 1, mesh=m)[0],)}
    walls = {}
    for name, fn in checks.items():
        want = fn(card0)
        got, ms = _timed(lambda: fn(cards))
        _, ms0 = _timed(lambda: fn(card0))
        if name.startswith("dedup"):
            if not np.array_equal(_host(got[0]), _host(want[0])):
                raise SmokeFailure(f"--mesh {name}: labels differ between "
                                   f"the cards and card 0")
        else:
            _equal_pairs(f"--mesh {name}", got, want)
        walls[name] = {"cards_ms": ms, "card0_ms": ms0}
        say(f"--mesh {name}: one shard a card == four shards on card 0; "
            f"{json.dumps(walls[name])}")
    e2e = end_to_end_phase(1_000_000)
    mesh = mesh_search_phase(device, tables, runs_pairs)
    overlap = (torch.cuda.device_count() == 1
               or mesh["bucketed_10M_reads"]["overlapping_cards"])
    for line in smi_lines:
        say(line)
    say(json.dumps({"mesh": {"cards": torch.cuda.device_count(),
                             "calibration_s": calib["seconds"],
                             "choices": calib["choices"],
                             "mesh_search": mesh, "checks": walls,
                             "auto_e2e_1M": {
                                 "engine": e2e["engine"],
                                 "seconds": e2e["seconds"],
                                 "k1": e2e["launches"]}}}))
    if not overlap:
        raise SmokeFailure("phase 25: at sweep_10M no two cards' K1 "
                           "kernels overlapped")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def onehot_products_ms(blocks) -> dict:
    """The one-hot route's matrix products alone, over the operands it
    multiplies (``blocks``: (first row, rows, column indices, columns)
    encodings from ``ops/hamming.py::onehot_tile_blocks``), CUDA-event
    means after a warm-up: ``bf16_ms`` as the route computes them
    (``onehot_products``), and ``int8_ms`` as ``torch._int_mm`` with int32
    sums over the same bands (the form the roofline counts; the route does
    not take it), its operands converted and padded beforehand (the
    call's shape rules)."""
    import torch

    from humid_tpu_torch.ops import hamming as H

    def bf16():
        for _, a, _, b in blocks:
            for _ in H.onehot_products(a, b):
                pass  # each product dropped at once, as the route does

    int8 = [(H.pad_rows(band.to(torch.int8)), b8) for _, a, _, b in blocks
            for b8 in [H.pad_rows(b.to(torch.int8))]
            for _, band in H.onehot_bands(a, b8)]

    def int8_products():
        for a8, b8 in int8:
            torch._int_mm(a8, b8.t())

    out = {"products": len(int8), "bf16_ms": time_cuda(bf16, 3),
           "int8_ms": time_cuda(int8_products, 3)}
    del int8
    torch.cuda.empty_cache()
    return out


def onehot_sweep_case(name, rows, tile_pairs, *, tile, u_pad, u, device,
                      k1: dict | None, with_plain: bool, max_dist: int = 1,
                      word_length: int = 24, ids=None,
                      products: bool = True) -> dict:
    """One sweep shape of phase 32: K1 (the wrapper) against the one-hot
    route (bf16 products on the card), and against the plain version,
    tolerance 0; the route whole timed, its device busy time from
    ``torch.profiler`` (``busy_ms``: the union of its kernels' intervals),
    and (``products``) its products alone (:func:`onehot_products_ms`);
    K1's times beside them from phase 3 (``k1``) or measured here."""
    import torch

    from humid_tpu_torch.ops import cuda_hamming as K
    from humid_tpu_torch.ops import hamming as H
    from humid_tpu_torch.ops.neighbors import sweep_tensors

    lanes, tp = sweep_tensors(rows, tile_pairs, device)
    if ids is not None:
        ids = torch.from_numpy(ids).to(device)
    kw = dict(tile=tile, part_stride=u_pad, part_valid=u, max_dist=max_dist,
              ids=ids)
    want = K.hamming_tile_pairs(lanes, tp, **kw)
    if with_plain:
        _equal_pairs(f"phase 32 {name}: K1 vs plain", want,
                     K.hamming_tile_pairs_plain(lanes, tp, **kw))
    out = {"pairs": int(len(want[0])), "tile_pairs": int(len(tp)),
           "plain_compared": with_plain,
           "k1_kernel_ms": k1["kernel_ms"] if k1 else sweep_kernel_ms(
               lanes, tp, kw, len(want[0]), 20),
           "k1_wrapper_ms": k1["ms"] if k1 else time_cuda(
               lambda: K.hamming_tile_pairs(lanes, tp, **kw), 5)}
    route = lambda: H.onehot_tile_pairs(lanes, tp, word_length=word_length,
                                        **kw)
    _equal_pairs(f"phase 32 {name}: one-hot vs K1", route(), want)
    out["route_ms"] = time_cuda(route, 3)
    trace = kernels_launched(route, f"onehot_{name}")
    out.update(route_kernels=trace["kernels"], route_busy_ms=trace["busy_ms"],
               route_busy_share=trace["busy_ms"] / out["route_ms"])
    if products:
        oh = H.onehot_bases(lanes, word_length,
                            dtype=H.onehot_dtype(lanes.device))
        blocks = list(H.onehot_tile_blocks(oh, tile_pairs, tile))
        out["matmul"] = onehot_products_ms(blocks)
        del blocks, oh
    torch.cuda.empty_cache()
    say(f"phase 32 {name}: one-hot route == K1"
        f"{' == plain' if with_plain else ''} (tolerance 0); "
        f"{json.dumps(out)}")
    return out


def onehot_phase(device, tables, sweeps, e2e) -> dict:
    """Phase 32: the neighbour engines' ``impl=`` choice.  The one-hot
    matrix-product route (the reference's ``impl="mxu"``) against K1 at
    dense_1M and sweep_1M and against K2 at ring_1M_d4's one step, pairs
    equal with tolerance 0, the plain version too where it is cheap; the
    route whole (its busy time too) and its products alone, CUDA-event
    means after a warm-up.  Then e2e_1M through ``run()`` with $HUMID_TPU_TORCH_IMPL=
    pallas (this slice's K1 path: counts reset just before, read just
    after), ``neighbor_opts={"impl": "mxu"}``, and ``{"strategy":
    "sharded", "impl": "pallas_ring"}`` (K2's), each byte-identical to
    phase 4's outputs."""
    from humid_tpu_torch import parallel as P
    from humid_tpu_torch.ops import hamming as H
    from humid_tpu_torch.ops import simplex_encode as SE
    from humid_tpu_torch.ops.neighbors import bucketed_inputs, dense_inputs
    from humid_tpu_torch.parallel import cuda_ring as R
    from humid_tpu_torch.parallel.mesh import pad_to_shards
    from humid_tpu_torch.parallel.neighbors import bucketed_shard_inputs

    uniq = tables["bucketed_1M_reads"]
    u = len(uniq)
    out = {}
    rows, tps, b, u_pad = dense_inputs(uniq, 2048)
    out["dense_1M"] = onehot_sweep_case(
        "dense_1M", rows, tps, tile=b, u_pad=u_pad, u=u, device=device,
        k1=sweeps["dense_1M"], with_plain=True)
    rows, tps, b, u_pad, _ = bucketed_inputs(uniq, 1, 24, 2048)
    out["sweep_1M"] = onehot_sweep_case(
        "sweep_1M", rows, tps, tile=b, u_pad=u_pad, u=u, device=device,
        k1=sweeps["bucketed_1M_reads"], with_plain=True)
    # The library cells of K1's other shapes: the route whole, K1 beside
    # it from phase 3 (phase 6's shape: measured here).
    big = tables["bucketed_10M_reads"]
    rows, tps, b, u_pad, _ = bucketed_inputs(big, 1, 24, 2048)
    out["sweep_10M"] = onehot_sweep_case(
        "sweep_10M", rows, tps, tile=b, u_pad=u_pad, u=len(big),
        device=device, k1=sweeps["bucketed_10M_reads"], with_plain=False,
        products=False)
    l33 = tables["dense_L33_m2"]
    rows, tps, b, u_pad = dense_inputs(l33, 2048)
    out["dense_L33_m2"] = onehot_sweep_case(
        "dense_L33_m2", rows, tps, tile=b, u_pad=u_pad, u=len(l33),
        device=device, k1=sweeps["dense_L33_m2"], with_plain=False,
        max_dist=2, word_length=33, products=False)
    prep = bucketed_shard_inputs(uniq, 1, 24, 4)
    out["ids_shard0"] = onehot_sweep_case(
        "ids_shard0", prep["rows"][0], prep["tile_pairs"][0],
        tile=prep["tile"], u_pad=prep["r_pad"], u=prep["urows"][0],
        device=device, k1=None, with_plain=False, ids=prep["ids"][0],
        products=False)

    # ring_1M_d4's one step (phase 8's): shard 0's block against block 1.
    d = 4
    bs = -(-u // d)
    lanes = _lanes(pad_to_shards(uniq, d, multiple=1), device)
    rows_b, cols_b = lanes[:bs], lanes[bs:2 * bs]
    kw = dict(row_base=0, col_base=bs, u=u, max_dist=1, upper_only=False)
    want = R.ring_block_pairs(rows_b, cols_b, **kw)
    _equal_pairs("phase 32 ring step: K2 vs plain", want,
                 R.ring_block_pairs_plain(rows_b, cols_b, **kw))
    n = len(want[0])
    step = {"pairs": n, "block_rows": bs}
    block = lambda: H.hamming_block_mxu(rows_b, cols_b, 0, bs, 1, n + 1, 24)
    r_idx, c_idx, count = block()
    if int(count) != n:
        raise SmokeFailure(f"phase 32 ring step: one-hot found {int(count)} "
                           f"pairs, K2 {n}")
    _equal_pairs("phase 32 ring step: one-hot vs K2",
                 (r_idx[:n].long(), c_idx[:n].long()), want)
    step["route_ms"] = time_cuda(block, 3)
    trace = kernels_launched(block, "onehot_ring_step")
    step.update(route_kernels=trace["kernels"],
                route_busy_ms=trace["busy_ms"],
                route_busy_share=trace["busy_ms"] / step["route_ms"])
    dtype = H.onehot_dtype(rows_b.device)
    step["matmul"] = onehot_products_ms([(
        0, H.onehot_bases(rows_b, 24, dtype=dtype), None,
        H.onehot_bases(cols_b, 24, dtype=dtype))])
    say(f"phase 32 ring_1M_d4 one step: one-hot block == K2 == plain "
        f"(tolerance 0); {json.dumps(step)}")
    out["ring_step"] = step

    # This slice's path: the impl choice through the user's entry point.
    runs = {}
    for name, env, opts in (
            ("impl_pallas", {"HUMID_TPU_TORCH_IMPL": "pallas"}, None),
            ("impl_mxu", {}, {"impl": "mxu"}),
            ("sharded_pallas_ring", {},
             {"strategy": "sharded", "impl": "pallas_ring",
              "mesh": P.data_mesh(d, device)})):
        R.LAUNCHES = SE.LAUNCHES = 0
        res, seconds, k1 = _with_env(env, lambda: _run_e2e(
            e2e, f"impl_{name}", device, neighbor_opts=opts))
        k2, encodes = R.LAUNCHES, SE.LAUNCHES
        engine = res.extra["engine"]
        _same_files(e2e["outs"][-1], os.path.join(WORK, f"out_impl_{name}"))
        runs[name] = {"seconds": seconds, "k1": k1, "k2": k2,
                      "encode": encodes, "engine": engine,
                      "neighbours_s": res.extra["timings"][
                          "Calculating neighbours using Hamming distance"]}
        say(f"phase 32 e2e_1M {name}: {json.dumps(runs[name])}; outputs == "
            + ("baseline/humid_ref" if e2e["humid_ref"] else "phase 4's"))
    wanted = {"impl_pallas": ("pallas", "k1"),
              "sharded_pallas_ring": ("pallas_ring", "k2")}
    for name, (impl, kernel) in wanted.items():
        # Both kernels read the tables the encoder made in the same run.
        if (runs[name][kernel] < 1 or runs[name]["encode"] < 1
                or runs[name]["engine"].get("impl") != impl):
            raise SmokeFailure(f"phase 32 {name}: {json.dumps(runs[name])}")
    if runs["impl_mxu"]["k1"] or runs["impl_mxu"]["engine"].get(
            "impl") != "mxu":
        raise SmokeFailure(f"phase 32: impl=mxu ran {runs['impl_mxu']}")
    out["e2e"] = runs
    return out


def library_entry(case: dict) -> dict:
    """The kernels line's library keys for one kernel: the one-hot route
    (the reference's ``impl="mxu"``, bf16 products as the port takes them
    on a card) on the same inputs, and its products alone."""
    return {"library_ms": case["route_ms"],
            "library_form": "one-hot bf16 matrix product (torch.matmul), "
                            "compare, nonzero (impl='mxu')",
            "library_matmul_ms": case["matmul"]["bf16_ms"]}


OPTIN_RUNNER = """
import json, os, sys, time
import humid_tpu_torch
from humid_tpu_torch import _backend
from humid_tpu_torch.cluster import exact
fastq, out_root, opts = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
walks = []
native_cluster = exact._native.cluster
def cluster(*args, **kw):
    walks.append(kw.get("parallel"))
    return native_cluster(*args, **kw)
exact._native.cluster = cluster
routes = {"overlap_unique": {"HUMID_TPU_TORCH_OVERLAP_UNIQUE": "1"},
          "cluster_parallel": {"HUMID_TPU_TORCH_CLUSTER": "parallel"},
          "default": {}}
rec = {name: [] for name in routes}
for _ in range(3):
    for name, env in routes.items():
        for var in ("HUMID_TPU_TORCH_OVERLAP_UNIQUE", "HUMID_TPU_TORCH_CLUSTER"):
            os.environ.pop(var, None)
        os.environ.update(env)
        del walks[:]
        t0 = time.perf_counter()
        res = humid_tpu_torch.run([fastq], dir_name=os.path.join(out_root, name),
                                  log_name="/dev/null", **opts)
        rec[name].append({"seconds": time.perf_counter() - t0,
                          "timings": res.extra["timings"],
                          "unique": res.extra["engine"].get("unique"),
                          "parallel_walk": walks[-1]})
print("OPTIN " + json.dumps({"runs": rec,
                             "extensions": _backend._host_extensions()}),
      flush=True)
"""


def _read_unique_s(timings: dict) -> float:
    """Seconds of pass 1 and unique counting together: the overlapped
    route's unique span covers its read."""
    if "unique counting (overlapped)" in timings:
        return timings["unique counting (overlapped)"]
    return timings["Reading data"] + timings.get("unique counting", 0.0)


def optin_routes_phase(e2e: dict, ext: dict | None) -> dict | None:
    """Phase 33: the two opt-in host routes on phase 24's tree (built with
    OpenMP where a compiler pair can link it): the overlapped pass 1 +
    unique route ($HUMID_TPU_TORCH_OVERLAP_UNIQUE=1) and the
    component-parallel walk ($HUMID_TPU_TORCH_CLUSTER=parallel), each
    alone, then the default, three rounds, in one subprocess per dataset
    (e2e_1M with phase 4's flags, bench_1M with bench.py's); every output
    byte-identical to baseline/humid_ref's; best of 3 of the read +
    unique seconds and the clustering seconds beside the default's."""
    if ext is None:
        say("phase 33 opt-in routes: no extension tree (phase 24 could not "
            "build the host extensions)")
        return None
    bench_dir = os.path.join(WORK, "tmp", "humid_tpu_torch_bench")
    out = {"openmp": ext["openmp"]}
    for name, fastq, ref, opts in (
            ("e2e_1M", e2e["fastq"], e2e["outs"][-1],
             {"word_length": 24, "distance": 1, "run_stats": True,
              "write_annotated": True}),
            ("bench_1M", os.path.join(bench_dir,
                                      f"bench_{BENCH_READS}.fastq"),
             os.path.join(bench_dir, "out_ref"), {"distance": 1})):
        dest = os.path.join(WORK, f"optin_{name}")
        proc = subprocess.run(
            [sys.executable, "-c", OPTIN_RUNNER, fastq, dest,
             json.dumps(opts)], cwd=ext["tree"], env=ext["env"],
            capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise SmokeFailure(f"phase 33 {name} failed:\n"
                               f"{proc.stderr[-4000:]}")
        rec = json.loads([ln for ln in proc.stdout.splitlines()
                          if ln.startswith("OPTIN ")][-1][6:])
        if rec["extensions"] != "111":
            raise SmokeFailure(f"phase 33 {name}: extensions "
                               f"{rec['extensions']}")
        runs = rec["runs"]
        if {r["unique"] for r in runs["overlap_unique"]} != {"overlapped"}:
            raise SmokeFailure(f"phase 33 {name}: the overlapped route did "
                               f"not engage: {runs['overlap_unique']}")
        if ({r["parallel_walk"] for r in runs["cluster_parallel"]} != {True}
                or {r["parallel_walk"] for r in runs["default"]} != {False}):
            raise SmokeFailure(f"phase 33 {name}: walks "
                               f"{json.dumps(runs)}")
        for route in runs:
            _same_files(ref, os.path.join(dest, route))
        best = {route: {
            "read_unique_s": min(_read_unique_s(r["timings"]) for r in rr),
            "clusters_s": min(r["timings"][DIRECTIONAL] for r in rr),
            "run_s": min(r["seconds"] for r in rr)}
            for route, rr in runs.items()}
        out[name] = best
        say(f"phase 33 {name} (best of 3; OpenMP {ext['openmp']}): "
            f"{json.dumps(best)}; every route's outputs == "
            + ("baseline/humid_ref" if name == "bench_1M" or e2e["humid_ref"]
               else "phase 4's"))
    return out


def _host(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is False")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode or not smi.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")
    from humid_tpu_torch import _build
    from humid_tpu_torch.tools.ring_profile import sample_table

    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True)
    card_info = {
        "sms": torch.cuda.get_device_properties(0).multi_processor_count,
        "sm_hz": float(clock.stdout.strip().splitlines()[0]) * 1e6}
    say(f"phase 1: {card}; {card_info['sms']} SMs, maximum SM clock "
        f"{card_info['sm_hz'] / 1e6:.0f} MHz")

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    # The router's constants go to a scratch cache of this run (phase 13),
    # which every later run() and CLI subprocess reads.
    os.environ["HUMID_TPU_TORCH_CALIB_PATH"] = os.path.join(
        WORK, "engine_calib.json")
    for var in ("HUMID_TPU_TORCH_FUSED", "HUMID_TPU_TORCH_DEVICE_ENGINE",
                "HUMID_TPU_TORCH_CALIBRATION", "HUMID_TPU_TORCH_STRATEGY",
                "HUMID_TPU_TORCH_UNIQUE", "HUMID_TPU_TORCH_SHARDS"):
        os.environ.pop(var, None)
    kernels = ("hamming_sweep", "ring_sweep", "simplex_encode")
    for name in kernels:  # build from this checkout's sources
        _build.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    libs = _build.build_all(kernels)
    say(f"phase 2: built {[os.path.relpath(p, REPO) for p in libs]} in "
        f"{time.perf_counter() - t0:.3f} s")
    for lib in libs:
        say(lib.with_suffix(".log").read_text().strip())
    # Geometry in tc_sweep.cuh: K1's narrow instance (128-column products
    # for short lists) exists where it differs, at w <= 2.
    for lib, kernel, ws in (("hamming_sweep", "hamming_sweep_kernel", (2, 3)),
                            ("hamming_sweep", "hamming_sweep_narrow_kernel",
                             (2,)),
                            ("ring_sweep", "ring_sweep_kernel", (2, 3))):
        mma = tc_products(_build.disassemble(lib), kernel)
        say(f"phase 2 {kernel} products (SASS): {json.dumps(mma)}")
        for w in ws:
            got = mma.get(f"w{w}", {})
            if (got.get("igmma", 0) < got.get("k_steps", 1)
                    or got["other_POPC"]
                    or not all(m.endswith(".S8.S8")
                               for m in got["mnemonics"])):
                raise SmokeFailure(
                    f"{kernel}, w = {w}: the products are not on the int8 "
                    f"warpgroup MMA (IGMMA ... S8.S8, one per k-step, no "
                    f"POPC loop): {mma}")

    device = torch.device("cuda")
    if sys.argv[1:] == ["--mesh"]:
        return mesh_main(device, smi.stdout.strip().splitlines())
    sweeps, tables = timed(3, sweep_phase, device, card_info)
    timed(13, calibration_phase, device, tables)
    e2e = timed(4, end_to_end_phase, 1_000_000)
    if e2e["launches"] < 1:
        raise SmokeFailure(f"phase 4: the default route ({e2e['engine']}) "
                           f"launched no tile sweep")
    # Phase 20 runs this early: the longer the process has run, the more
    # of K2's kernels its torch.profiler trace loses (PERF.md).
    mesh_labels = timed(20, mesh_labels_phase, e2e, device, card_info)
    uniq_1m = tables["bucketed_1M_reads"]
    ring_err = timed(5, ring_step_phase, device, uniq_1m,
                     tables["dense_L33_m2"])
    timed(6, ids_phase, device, uniq_1m, card_info)
    table_65k = sample_table(400_000, seed=7)[:65536]
    timed(7, ring_schedule_phase, device, table_65k)
    ring = timed(8, ring_main_shape_phase, device, uniq_1m, card_info)
    mesh_launches = timed(9, mesh_end_to_end_phase, e2e)
    timed(10, edit_dp_phase, device)
    table_indels = with_indels(tables["dense_L33_m2"], 33, 8192, seed=1)
    timed(11, edit_engines_phase, device, table_indels,
          with_indels(table_65k, 24, 65536, seed=2), uniq_1m, card_info)
    timed(12, edit_end_to_end_phase, e2e)
    timed(12, edit_indel_end_to_end_phase, e2e, table_indels)
    _, runs_pairs = timed(14, engines_agree_phase, device, tables)
    timed(15, programs_phase, device, card_info)
    routes = timed(16, routes_phase, e2e)
    mp_1m = timed(17, mp_1m_phase, e2e, device)
    mp_big = timed(18, mp_big_runs_phase)
    mp_edit_gz = timed(19, mp_edit_gz_phase, e2e)
    timed(21, startup_phase)
    directional = timed(22, directional_device_phase, e2e, device,
                        card_info)
    timed(23, profile_phase, e2e, device)
    ext = timed(24, host_extensions_phase, e2e)
    mesh = timed(25, mesh_search_phase, device, tables, runs_pairs)
    bench_k1 = timed(27, bench_phase, ext, card)
    # Phase 31's host half (CPU only) runs beside the two fuzz campaigns,
    # which are checks, not timings; it ends before phase 30 times the
    # engines, and the device half runs after those timings.
    host = check_native_start()
    try:
        fuzz = timed(28, fuzz_oracle_phase)
        timed(29, fuzz_multiproc_phase)
    except BaseException:
        _stop_group(host[0])
        raise
    host = timed("31 (host half)", check_native_wait, host)
    timed(30, engine_xover_phase, device, card)
    native = timed(31, check_native_phase, host)
    onehot = timed(32, onehot_phase, device, tables, sweeps, e2e)
    timed(33, optin_routes_phase, e2e, ext)

    main_shape = sweeps["dense_1M"]
    impl_runs = onehot["e2e"]
    say(json.dumps({"kernels": [{
        "name": "hamming_sweep", "route": "cuda",
        "source": "humid_tpu_torch/csrc/hamming_sweep.cu",
        "replaces": "humid_tpu/ops/pallas_hamming.py:60",
        # This slice's path: e2e_1M through run() with
        # HUMID_TPU_TORCH_IMPL=pallas (phase 32); the earlier paths'
        # counts beside it.
        "launches": impl_runs["impl_pallas"]["k1"],
        "launches_by_path": {
            "impl_pallas_e2e_1M": impl_runs["impl_pallas"]["k1"],
            "fuzz_oracle": fuzz["launches"]["hamming_sweep"],
            "auto_e2e_1M": e2e["launches"],
            "mesh_bucketed_sweep_1M": mesh["bucketed_1M_reads"]["launches"],
            "directional_1M_pairs": directional["k1"],
            "directional_device_e2e_1M": directional["e2e"]["k1"],
            "mp_big_runs": mp_big["k1"], "mp_1M": mp_1m["k1"],
            "mp_edit": mp_edit_gz["mp_edit"]["k1"],
            "mp_gz": mp_edit_gz["mp_gz"]["k1"],
            "big_runs_default": routes["big_runs_default"]["launches"],
            "bucketed_e2e_1M": routes["bucketed"]["launches"],
            "bench_1M": bench_k1},
        "max_abs_err": max(r["max_abs_err"] for r in sweeps.values()),
        # ms: the kernel alone, for both kernels; wrapper_ms: through the
        # wrapper (allocation, read-back and sort included).
        "ms": main_shape["kernel_ms"], "wrapper_ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        # The bound of the form K1 runs (the simplex int8 tensor-core
        # form, ``form``).
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "form": main_shape["form"],
        # The card's least time: the least of the POPC, one-hot and
        # simplex forms' bounds (``roofline``).
        "roofline_ms": main_shape["roofline_ms"],
        "roofline_by": main_shape["roofline_by"],
        "roofline_form": main_shape["roofline_form"],
        # The same function by the reference's impl="mxu" route, at
        # dense_1M (phase 32; sweep_1M's there too).
        **library_entry(onehot["dense_1M"]),
        "sanitizer": sanitizer_entry(native, "hamming_sweep")}, {
        "name": "ring_sweep", "route": "cuda",
        "source": "humid_tpu_torch/csrc/ring_sweep.cu",
        "replaces": "humid_tpu/parallel/pallas_ring.py:75",
        # This slice's path: e2e_1M through run() with strategy "sharded"
        # and impl "pallas_ring" on 4 shards (phase 32); the earlier
        # paths' counts beside it.
        "launches": impl_runs["sharded_pallas_ring"]["k2"],
        "launches_by_path": {"sharded_pallas_ring_e2e_1M":
                             impl_runs["sharded_pallas_ring"]["k2"],
                             "fuzz_oracle": fuzz["launches"]["ring_sweep"],
                             "mesh_labels_dedup_step":
                             mesh_labels["k2_launches"],
                             "ring_e2e_1M": mesh_launches["ring"]},
        "max_abs_err": max(ring_err, ring["max_abs_err"]),
        "ms": ring["step_kernel_ms"], "wrapper_ms": ring["step_ms"],
        "no_hit_ms": ring["step_no_hit_kernel_ms"],
        "plain_ms": ring["step_plain_ms"],
        "bound_ms": ring["bound_ms"], "bound_by": ring["bound_by"],
        "form": ring["form"], "roofline_ms": ring["roofline_ms"],
        "roofline_by": ring["roofline_by"],
        "roofline_form": ring["roofline_form"],
        "ring_ms": ring["kernel_ms_all_steps"],
        "ring_bound_ms": ring["ring_bound_ms"],
        **library_entry(onehot["ring_step"]),
        "sanitizer": sanitizer_entry(native, "ring_sweep")}, {
        # The pre-pass of both kernels: packed lanes -> the simplex table.
        # It stands for the TPU ring kernel's in-VMEM expansion of the
        # packed block it received (_build_oht).
        "name": "simplex_encode", "route": "cuda",
        "source": "humid_tpu_torch/csrc/simplex_encode.cu",
        "replaces": "humid_tpu/parallel/pallas_ring.py:55",
        # The same run as the ring's: one encode a K2 launch.
        "launches": impl_runs["sharded_pallas_ring"]["encode"],
        "launches_by_path": {
            "sharded_pallas_ring_e2e_1M":
                impl_runs["sharded_pallas_ring"]["encode"],
            "impl_pallas_e2e_1M": impl_runs["impl_pallas"]["encode"],
            "ring_1M_d4": ring["encodes_per_ring"]},
        "max_abs_err": ring["encode_max_abs_err"],
        # ms: one ring block (ring_1M_d4's) into the shard's buffer, the
        # kernel's own time (profiler); events_ms: back-to-back launches
        # between CUDA events, which the host's set-up paces.
        "ms": ring["encode_device_ms"] or ring["encode_ms"],
        "events_ms": ring["encode_ms"],
        "plain_ms": ring["encode_plain_ms"],
        "bound_ms": ring["encode_bound_ms"], "bound_by": "bytes",
        "slot_bytes": ring["slot_bytes"],
        "encoded_bytes": ring["encoded_bytes"],
        # No one PyTorch call computes the encoding (its plain version is
        # a chain of elementwise operations).
        "library_ms": None}]}))
    say(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        say(f"FAIL: {exc}")
        sys.exit(1)
