"""Wide randomized end-to-end fuzz of the port against the string oracle.

    python -m humid_tpu_torch.tools.fuzz_oracle [n_configs] [start_seed]
                                                [--device D] [--shards S]

Counterpart of the JAX package's ``scripts/fuzz_oracle.py``: a hunt
campaign over many seeds, not a CI gate (``tests/test_torch_fuzz.py``
keeps 20 fixed cases).  Defaults: 100 configs from seed 10,000
on ``resolve_device()``'s device (CUDA unless ``--device cpu`` or
HUMID_TPU_TORCH_DEVICE=cpu; without a card it raises), with
HUMID_TPU_TORCH_SHARDS=8 (the reference's virtual mesh: more shards than
cards go round-robin on the cards there are).

:func:`draw_config` makes the reference's random calls in the reference's
order, so a seed draws the same dataset, flags and engine there and here:
``-m 0-3``, ``-n 0-39``, ``-e``, ``-x``, 1-3 files, UMI styles, gzip,
ragged reads, unequal files, 50-500 reads, the batch size, the span-cache
writer, one of the seven engines forced (``auto`` among them), pools of
1-4 sequences, the fused route and device directional clustering.  Three
dimensions of the reference have no counterpart in the port (ROADMAP.md,
"What not to port"): the overlapped pass 1, the ``parallel`` cluster route
and the host edit verifier.  They are drawn all the same, so the stream of
random numbers stays the reference's, recorded in a case's report as
``not_ported``, and change nothing.

Each case runs ``humid_tpu_torch.run`` in process and :func:`check_case`
holds its outputs against ``tests/oracle.py`` record for record (dedup
and annotated outputs, the four statistics files, the scalar counts).
The last line of the output is one JSON summary: configs, failures, cases
per engine that ran, the forced strategies and routes, K1 and K2 launches
over the campaign, seconds.  A case that differs from the oracle is
printed with its seed, its config and the traceback, and the tool exits 1.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

from .._device import resolve_device
from ..io.names import make_file_name
from ..pipeline import run

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TESTS = os.path.join(REPO, "tests")

#: The engines a case may force (None: ``auto``), as the reference lists
#: them; edit runs draw from the second list.
STRATEGIES = [None, "runs", "dense", "bucketed", "runs_device", "sharded",
              "sharded_bucketed"]
EDIT_STRATEGIES = [None, "dense", "sharded"]

#: What a case sets, each restored after it.
ENV_VARS = ("HUMID_TPU_TORCH_SPAN_CACHE", "HUMID_TPU_TORCH_STRATEGY",
            "HUMID_TPU_TORCH_FUSED", "HUMID_TPU_TORCH_CLUSTER",
            "HUMID_TPU_TORCH_SHARDS")


def _testing_helpers():
    """The generator and the string oracle of ``tests/`` (standard library
    and numpy only)."""
    if TESTS not in sys.path:
        sys.path.insert(0, TESTS)
    from genfastq import gen_dataset, parse_fastq
    from oracle import oracle_run

    return gen_dataset, parse_fastq, oracle_run


def _read_hist(path) -> dict:
    with open(path) as fh:
        return {int(a): int(b) for a, b in
                (line.split() for line in fh if line.strip())}


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def check_case(tmp_path, rng, *, n_files=1, umi_style="none", gz=False,
               distance=1, word_length=24, edit=False, maximum=False,
               ragged=False, unequal=False, n_reads=250,
               batch_records=1 << 19, pool_size=40, device=None):
    """One dataset drawn from ``rng`` (``tests/genfastq.py``) through the
    port's ``run()`` on ``device`` and the string oracle, compared end to
    end; raises AssertionError on the first difference.  The port's
    counterpart of ``tests/test_pipeline.py::_check_case``.  Returns
    (PipelineResult, OracleResult)."""
    gen_dataset, parse_fastq, oracle_run = _testing_helpers()
    src = Path(tmp_path) / "in"
    out = Path(tmp_path) / "out"
    os.makedirs(src, exist_ok=True)
    paths, files_records = gen_dataset(
        rng, str(src), n_reads=n_reads, n_files=n_files, umi_style=umi_style,
        gz=gz, ragged=ragged, unequal_lengths=unequal,
        read_len=18 if edit else 30, pool_size=pool_size)
    res = run(list(paths), word_length=word_length, distance=distance,
              log_name=str(out / "log.txt"), dir_name=str(out),
              run_stats=True, write_dedup=True, write_annotated=True,
              edit=edit, maximum=maximum, batch_records=batch_records,
              device=device)
    exp = oracle_run(files_records, word_length=word_length,
                     distance=distance, edit=edit, maximum=maximum)

    got = (res.total, res.usable, res.unique, res.clusters)
    want = (exp.total, exp.usable, exp.unique, len(exp.clusters))
    _expect(got == want, f"(total, usable, unique, clusters) {got} != "
                         f"oracle's {want}")
    for f, p in enumerate(paths):
        records = files_records[f]
        dedup = parse_fastq(make_file_name(p, str(out), "dedup"))
        _expect(dedup == [(name, seq, "+", "F" * len(seq)) for name, seq in
                          (records[t] for t in exp.rep_tuples)],
                f"dedup mismatch file {f}")
        annotated = parse_fastq(make_file_name(p, str(out), "annotated"))
        _expect(annotated == [
            (f"{records[t][0]}:{exp.cluster_of_read[t]}", records[t][1],
             "+", "F" * len(records[t][1])) for t in range(exp.total)],
            f"annotated mismatch file {f}")
    for name, hist in (("counts.dat", exp.counts_hist),
                       ("neigh.dat", exp.neigh_hist),
                       ("clusters.dat", exp.cluster_hist)):
        got_hist = _read_hist(out / name)
        _expect(got_hist == hist, f"{name}: {got_hist} != oracle's {hist}")
    with open(out / "stats.dat") as fh:
        stats = {k: int(v) for k, v in (ln.strip().split(": ") for ln in fh)}
    got = (stats["total"], stats["usable"], stats["unique"],
           stats["clusters"])
    _expect(got == want, f"stats.dat {got} != oracle's {want}")
    return res, exp


def draw_config(seed: int) -> tuple[dict, np.random.Generator]:
    """The reference's draw for ``seed`` (scripts/fuzz_oracle.py, the loop
    body up to its ``_check_case`` call), call for call.  Returns the case
    (``cfg``: :func:`check_case`'s keywords; the knobs ``span``,
    ``strategy``, ``overlap``, ``fused``, ``cluster``, ``edit_verify``)
    and the generator, positioned where the reference hands it to the
    dataset generator."""
    rng = np.random.default_rng(seed)
    n_files = int(rng.integers(1, 4))
    edit = bool(rng.integers(0, 4) == 0)
    cfg = dict(
        n_files=n_files,
        umi_style=["none", "underscore", "colon"][int(rng.integers(0, 3))],
        gz=bool(rng.integers(0, 2)),
        distance=int(rng.integers(0, 4)),
        word_length=int(rng.integers(0, 40)),
        edit=edit,
        maximum=bool(rng.integers(0, 2)),
        ragged=bool(rng.integers(0, 2)),
        unequal=bool(rng.integers(0, 2)) and n_files > 1,
        n_reads=int(rng.integers(50, 500)),
        batch_records=int(rng.choice([64, 1 << 10, 1 << 19])),
    )
    span = bool(rng.integers(0, 2))
    strategies = STRATEGIES if not edit else EDIT_STRATEGIES
    strategy = strategies[int(rng.integers(0, len(strategies)))]
    if rng.integers(0, 4) == 0:
        cfg["pool_size"] = int(rng.choice([1, 2, 4]))
    overlap = bool(rng.integers(0, 3) == 0)
    fused = (bool(rng.integers(0, 3) == 0) and strategy is None
             and not overlap)
    cluster = [None, "parallel", "device"][
        int(rng.integers(0, 3)) if rng.integers(0, 2) else 0]
    edit_verify = (["host", "device"][int(rng.integers(0, 2))]
                   if edit and rng.integers(0, 2) else None)
    case = dict(cfg=cfg, span=span, strategy=strategy, overlap=overlap,
                fused=fused, cluster=cluster, edit_verify=edit_verify)
    return case, rng


def not_ported(case: dict) -> list[str]:
    """The drawn dimensions the port has no counterpart of (recorded,
    without effect): the overlapped pass 1, the ``parallel`` cluster
    route, the host edit verifier (the port verifies on the device)."""
    return [what for what, drawn in (
        ("overlap", case["overlap"]),
        ("cluster=parallel", case["cluster"] == "parallel"),
        ("edit_verify=host", case["edit_verify"] == "host")) if drawn]


def case_env(case: dict, shards: int) -> dict:
    """The port's variables for ``case``: name -> value, None for unset."""
    return {
        "HUMID_TPU_TORCH_SPAN_CACHE": "1" if case["span"] else None,
        "HUMID_TPU_TORCH_STRATEGY": case["strategy"],
        "HUMID_TPU_TORCH_FUSED": "1" if case["fused"] else None,
        "HUMID_TPU_TORCH_CLUSTER": ("device" if case["cluster"] == "device"
                                    else None),
        "HUMID_TPU_TORCH_SHARDS": str(shards),
    }


def _set_env(env: dict) -> None:
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def run_case(seed: int, device, shards: int = 8) -> dict:
    """Draw ``seed``'s case, run it with its variables set (restored
    after), check it against the oracle; returns its report (raises
    AssertionError on a difference)."""
    case, rng = draw_config(seed)
    saved = {k: os.environ.get(k) for k in ENV_VARS}
    _set_env(case_env(case, shards))
    try:
        with tempfile.TemporaryDirectory() as d:
            res, _ = check_case(d, rng, device=device, **case["cfg"])
    finally:
        _set_env(saved)
    engine = res.extra["engine"]
    return dict(case, seed=seed, engine=engine.get("strategy", "none"),
                unique=engine.get("unique"), not_ported=not_ported(case))


def _launches() -> dict:
    from ..ops import cuda_hamming
    from ..parallel import cuda_ring

    return {"hamming_sweep": cuda_hamming.LAUNCHES,
            "ring_sweep": cuda_ring.LAUNCHES}


def campaign(seeds, device, shards: int = 8) -> dict:
    """Every seed of ``seeds`` through :func:`run_case`; prints progress
    every 25 cases and each failure as it happens; returns the summary."""
    t0 = time.perf_counter()
    before = _launches()
    tally = {k: collections.Counter() for k in (
        "engines", "strategies", "routes", "not_ported")}
    failures = []
    seeds = list(seeds)
    for i, seed in enumerate(seeds):
        try:
            rep = run_case(seed, device, shards)
            status = "ok"
        except Exception:
            case, _ = draw_config(seed)
            failures.append({"seed": seed, "case": case,
                             "traceback": traceback.format_exc()})
            status = "FAIL"
            rep = case
        else:
            tally["engines"][rep["engine"]] += 1
            tally["not_ported"].update(rep["not_ported"])
        tally["strategies"][rep["strategy"] or "auto"] += 1
        for route, drawn in (("fused", rep["fused"]),
                             ("cluster_device", rep["cluster"] == "device"),
                             ("edit", rep["cfg"]["edit"]),
                             ("maximum", rep["cfg"]["maximum"]),
                             ("span_cache", rep["span"]),
                             ("pool_size", "pool_size" in rep["cfg"])):
            tally["routes"][route] += int(bool(drawn))
        if status == "FAIL":
            f = failures[-1]
            print(f"[{i + 1}/{len(seeds)}] seed={seed} FAIL "
                  f"case={json.dumps(f['case'])}\n{f['traceback']}",
                  flush=True)
        elif (i + 1) % 25 == 0:
            print(f"[{i + 1}/{len(seeds)}] seed={seed} ok", flush=True)
    after = _launches()
    return {"configs": len(seeds), "failures": len(failures),
            "failed_seeds": [f["seed"] for f in failures],
            "device": str(device), "shards": shards,
            **{k: dict(sorted(v.items())) for k, v in tally.items()},
            "launches": {k: after[k] - before[k] for k in after},
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_configs", type=int, nargs="?", default=100)
    p.add_argument("start_seed", type=int, nargs="?", default=10_000)
    p.add_argument("--device", default=None,
                   help="cuda (default, or $HUMID_TPU_TORCH_DEVICE) or cpu")
    p.add_argument("--shards", type=int, default=8,
                   help="HUMID_TPU_TORCH_SHARDS of every case (default 8)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    summary = campaign(range(args.start_seed,
                             args.start_seed + args.n_configs), device,
                       args.shards)
    n = summary["configs"]
    if summary["failures"]:
        print(f"{summary['failures']} of {n} configs differ from the "
              f"oracle: seeds {summary['failed_seeds']}")
    else:
        print(f"all {n} configs match the oracle")
    print(json.dumps(summary), flush=True)
    return 1 if summary["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
