"""The control of the benchmark's comparison: the plain reference put in
the program's place with one guarantee broken, which the comparison has to
judge not correct.

    python benchmark/control.py --workload <config>.<traffic> --seeds N ...

For each seed it makes (or finds) the cell's FastQ files, runs the
reference, and runs the control: the same reference whose neighbour
search visits only the first of its ``m + 1`` pigeonhole segments (under
``edit``: that segment at shift 0 only), so the pairs whose mismatches or
indels all fall there are never found (the guarantee that every pair
within ``m`` is a neighbour is broken).  The control's
statistics files and arrays go through the harness's own comparison, and
one JSON line a seed gives each number compared beside its limit.  It
needs no card and is not part of a benchmark run.
"""

import argparse
import json
import os
import sys
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from pbench import harness  # noqa: E402
from reference import humid_np  # noqa: E402


def readings(files, flags, search_segments=1) -> dict:
    """The comparison's numbers for the control on ``files``."""
    edit = flags.get("edit", False)
    ref = humid_np.humid(files, flags["word_length"], flags["distance"],
                         edit=edit)
    ctl = humid_np.humid(files, flags["word_length"], flags["distance"],
                         search_segments=search_segments, edit=edit)
    with tempfile.TemporaryDirectory(prefix="portbench-control-") as d:
        for name, data in ctl.files.items():
            with open(os.path.join(d, name), "wb") as f:
                f.write(data)
        checks, _ = harness.compare(
            ref, [(0, d)], [(0, ctl.counts, ctl.degree, ctl.rep_reads)])
    return checks


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    _, _, config, traffic = harness.cell(args.workload)
    harness.refuse_unjudged(config["run"])
    for seed in args.seeds:
        t = time.perf_counter()
        meta = harness.Inputs(config, traffic, seed, args.workload).wait()
        checks = readings(meta["files"], config["run"])
        fails = [k for k, c in checks.items() if c["value"] > c["limit"]]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": not fails, "checks": checks,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
