"""The traffic generator: deterministic per seed, and at a reduced scale
the unique words and duplicate shares that the traffic files' formulas
give."""

import json
import math
import os

import numpy as np
import pytest

from conftest import BENCH
from pbench import generate, harness
from reference import humid_np


def _cell(name):
    """The configuration and the traffic of ``<config>.<traffic>``, found
    by name (also a traffic file that waits for its cell)."""
    cfg, trf = name.split(".")
    return (harness.load_json(os.path.join(BENCH, "configs", f"{cfg}.json")),
            harness.load_json(os.path.join(BENCH, "traffic", f"{trf}.json")))


@pytest.mark.parametrize("name", ["se100_default.wgs_qc",
                                  "pe150_umi8_m2.umi_qc",
                                  "se100_default.wgs_deep"])
def test_same_seed_same_bytes_other_seed_other_bytes(tmp_path, name):
    config, traffic = _cell(name)
    traffic = {**traffic, "reads": 3000, "molecules": 4000}
    outs = []
    for k, seed in enumerate((2 ** 31 + 11, 2 ** 31 + 11, 7)):
        d = tmp_path / str(k)
        d.mkdir()
        meta = generate.generate(config, traffic, seed, str(d))
        outs.append([open(f, "rb").read() for f in meta["files"]])
    assert outs[0] == outs[1]
    assert outs[0] != outs[2]
    assert len(outs[0]) == config["layout"]["files"]


def test_duplicate_share_sample_matches_its_formula(tmp_path):
    """Each of the F = reads (1 - share) fragments has 1 + Poisson(l) reads,
    l = share / (1 - share); each read's 24-base word takes an error with
    q = 1 - (1 - p)^24.  A fragment gives one clean word unless all its
    reads erred, and every erring read a word of its own:
    U = F (1 - q e^(-l (1 - q))) + reads q."""
    config, traffic = _cell("se100_default.wgs_qc")
    reads, share, p = 200_000, traffic["duplicate_share"], 0.002
    traffic = {**traffic, "reads": reads}
    meta = generate.generate(config, traffic, 123456789012, str(tmp_path))
    ref = humid_np.humid(meta["files"], 24, 1)
    frags, lam = reads * (1 - share), share / (1 - share)
    q = 1 - (1 - p) ** 24
    want = frags * (1 - q * math.exp(-lam * (1 - q))) + reads * q
    assert ref.total == reads
    assert abs(len(ref.keys) - want) / want < 0.002


def test_uniform_draws_sample_matches_its_formula(tmp_path):
    """Draws of R reads from M molecules see M (1 - e^(-R/M)) of them;
    each read's word (UMI and 8 + 8 bases) takes an error with
    1 - (1 - p)^24."""
    config, traffic = _cell("pe150_umi8_m2.umi_qc")
    ratio = traffic["reads"] / traffic["molecules"]
    molecules = 300_000
    reads = int(round(ratio * molecules))
    traffic = {**traffic, "reads": reads, "molecules": molecules}
    meta = generate.generate(config, traffic, 98765, str(tmp_path))
    ref = humid_np.humid(meta["files"], 24, 2)
    seen = molecules * (1 - math.exp(-ratio))
    q = 1 - (1 - 0.002) ** 24
    # Seen molecules whose every read has an error have no clean word.
    clean = molecules * (1 - math.exp(-ratio * (1 - q)))
    want = clean + reads * q
    assert ref.total == reads
    assert abs(len(ref.keys) - want) / want < 0.01
    assert abs(1 - seen / reads - 0.26) < 0.01


def test_generator_as_a_child_prints_its_files(tmp_path):
    import subprocess
    import sys

    config, traffic = _cell("se100_default.wgs_qc")
    traffic = {**traffic, "reads": 500}
    (tmp_path / "c.json").write_text(json.dumps(config))
    (tmp_path / "t.json").write_text(json.dumps(traffic))
    out = subprocess.run(
        [sys.executable, generate.__file__, str(tmp_path / "c.json"),
         str(tmp_path / "t.json"), "5", str(tmp_path)],
        capture_output=True, text=True, check=True).stdout
    meta = json.loads(out.strip().splitlines()[-1])
    assert meta["reads"] == 500
    data = open(meta["files"][0], "rb").read()
    assert data.count(b"\n") == 4 * 500
    assert os.path.basename(meta["files"][0]) == "r1.fastq"
    assert np.frombuffer(data, np.uint8).max() < 128
