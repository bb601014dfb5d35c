"""The cell ``se200_edit_m2.indel_qc`` on the CPU: its generator
(deterministic from the seed, the configured layout, the traffic's
error rates measured against the fragments), the harness's run of the
cell at a few thousand reads (correct, on the stated route, every new
reader reading, the port's distinct candidates equal to the
reference's), and the control failing that sample."""

import json
import os

import numpy as np
import pytest

import control
from conftest import BENCH
from pbench import generate, harness

CELL = "se200_edit_m2.indel_qc"
CONFIG = harness.load_json(os.path.join(BENCH, "configs",
                                        "se200_edit_m2.json"))
TRAFFIC = harness.load_json(os.path.join(BENCH, "traffic", "indel_qc.json"))
SMALL = {"reads": 5000}
READERS = ("edit_neighbours_ms", "edit_joins_ms", "edit_dedupe_ms",
           "edit_verify_host_ms", "edit_verify_wait_ms")


def _fastq(path):
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    assert lines[-1] == b""
    return lines[:-1]


def test_same_seed_same_bytes_and_the_configured_layout(tmp_path):
    traffic = {**TRAFFIC, "reads": 3000}
    outs = []
    for k, seed in enumerate((2 ** 31 + 29, 2 ** 31 + 29, 11)):
        d = tmp_path / str(k)
        d.mkdir()
        meta = generate.generate(CONFIG, traffic, seed, str(d))
        assert meta["reads"] == 3000
        outs.append([open(f, "rb").read() for f in meta["files"]])
    assert outs[0] == outs[1] and outs[0] != outs[2]
    assert len(outs[0]) == CONFIG["layout"]["files"] == 1
    lines = _fastq(meta["files"][0])
    assert len(lines) == 4 * 3000
    read_length = CONFIG["layout"]["read_length"]
    assert {len(s) for s in lines[1::4]} == {read_length}
    assert set(b"".join(lines[1::4])) == set(b"ACGT")
    assert all(n.startswith(b"@r") and b"_" not in n for n in lines[::4])


def _read_edits(reads, frags, band=8):
    """The least edits that turn each read into a prefix of its fragment
    (the DP of the textbook inside a band of ``band`` around the
    diagonal, the fragment's end free)."""
    n, length = reads.shape
    inf = 1 << 20
    width = 2 * band + 1
    # prev[k] is D[i - 1][i - 1 + k - band]; row 0 is D[0][j] = j.
    prev = np.full((width, n), inf, np.int64)
    for k in range(band, width):
        prev[k] = k - band
    for i in range(1, length + 1):
        cur = np.full((width, n), inf, np.int64)
        for k in range(width):
            j = i + k - band
            if j < 0 or j > frags.shape[1]:
                continue
            if j == 0:
                cur[k] = i
                continue
            v = prev[k] + (reads[:, i - 1] != frags[:, j - 1])
            if k + 1 < width:
                v = np.minimum(v, prev[k + 1] + 1)
            if k:
                v = np.minimum(v, cur[k - 1] + 1)
            cur[k] = v
        prev = cur
    return prev.min(axis=0)


# (indel rate, substitution rate) applied, and the reads: enough for
# about 4,000 errors (a relative standard error of 1.6%).
RATES = {"traffic": (TRAFFIC["indel_rate"], TRAFFIC["substitution_rate"],
                     2000),
         "indels": (TRAFFIC["indel_rate"], 0.0, 2000),
         "substitutions": (0.0, TRAFFIC["substitution_rate"], 20000)}


@pytest.mark.parametrize("case", sorted(RATES))
def test_error_rates_match_the_traffic(case):
    """Edits a base of reads against their fragments: the indel rate plus
    the substitution rate, within 8% (five standard errors; two events
    that one edit explains, such as an insertion beside a deletion, are
    some 1% of them)."""
    indel, sub, n = RATES[case]
    gen = generate.generator(TRAFFIC)
    read_length = CONFIG["layout"]["read_length"]
    rng = np.random.default_rng(2 ** 31 + 3)
    frags = generate.random_codes(rng, n, read_length + gen.SPARE)
    reads = gen.mutate(rng, frags, read_length, indel, sub)
    assert reads.shape == (n, read_length) and reads.dtype == np.uint8
    if indel == 0:
        # Substitutions alone change bases in place.
        edits = (reads != frags[:, :read_length]).sum(axis=1)
    else:
        edits = _read_edits(reads, frags)
    rate = edits.sum() / (n * read_length)
    assert abs(rate / (indel + sub) - 1) < 0.08, rate


def test_cell_runs_correct_on_its_route_and_every_reader_reads(bench_env,
                                                               capsys):
    rc = harness.main(["--workload", CELL, "--seed", "3000000053",
                       "--seconds", "0.3", "--trace", "1"],
                      on_card=False, build=False, traffic_override=SMALL)
    captured = capsys.readouterr()
    assert rc == 0
    line = json.loads(captured.out.strip().splitlines()[-1])
    err = captured.err
    assert line["correct"] is True and line["failed"] == 0
    assert all(c["value"] == 0 for c in line["checks"].values())
    route_line = next(ln for ln in err.splitlines()
                      if ln.startswith("# route:"))
    assert "as stated" in route_line and "NOT as stated" not in route_line
    route = json.loads(route_line[len("# route: "):].split(" as stated")[0])
    assert route["metric"] == "edit" and route["strategy"] == "runs"
    assert route["join_cap_fallbacks"] == 0
    metrics = line["metrics"]
    assert all(metrics[name]["value"] > 0 for name in READERS)
    spans = sum(metrics[name]["value"] for name in READERS[1:])
    assert spans <= metrics["edit_neighbours_ms"]["value"]
    # The Hamming cells' neighbour readers find nothing here.
    assert "neighbours_ms" not in metrics
    # The reference counted the same distinct candidates as the port.
    ref_line = next(ln for ln in err.splitlines()
                    if ln.startswith("# reference:"))
    assert f" {route['distinct_candidates']} candidates" in ref_line


def test_control_is_not_correct_on_the_cell(bench_env):
    traffic = {**TRAFFIC, **SMALL}
    meta = harness.Inputs(CONFIG, traffic, 2147483687, CELL).wait()
    checks = control.readings(meta["files"], CONFIG["run"])
    assert checks["neighbour_degrees_differing"]["value"] > 0
    assert checks["stats_files_differing"]["value"] > 0
    sound = control.readings(meta["files"], CONFIG["run"],
                             search_segments=None)
    assert all(c["value"] == 0 for c in sound.values())
