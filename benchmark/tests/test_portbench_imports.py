"""No module that the harness or the reference loads has the top-level
name ``jax`` or ``humid_tpu`` (or ``jaxlib``, ``flax``), and the
reference loads nothing of the program either; names are compared whole,
so ``humid_tpu_torch`` is not ``humid_tpu``."""

import json
import subprocess
import sys

from conftest import BENCH, ROOT

PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(body: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(bench=BENCH, root=ROOT,
                                            body=body)],
        capture_output=True, text=True, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_reference_loads_no_jax_and_nothing_of_either_package():
    names = _top_level("from reference import humid_np\n"
                       "import control")
    names -= {"pbench"}  # control.py loads the harness's comparison
    assert not names & {"jax", "jaxlib", "flax", "humid_tpu"}
    loaded = _top_level("from reference import humid_np")
    assert not loaded & {"jax", "jaxlib", "flax", "humid_tpu",
                         "humid_tpu_torch", "torch"}


def test_harness_and_program_load_no_jax():
    names = _top_level(
        "from pbench import harness, trace, roofline, generate\n"
        "import humid_tpu_torch\n"
        "from humid_tpu_torch import pipeline, _backend\n"
        "from reference import humid_np")
    assert "humid_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "humid_tpu"}


def test_harness_refuses_a_run_with_jax_loaded(bench_env, monkeypatch,
                                               capsys):
    """The check after the window compares whole top-level names."""
    import types

    from pbench import harness

    monkeypatch.setitem(sys.modules, "humid_tpu", types.ModuleType("x"))
    rc = harness.main(["--workload", "se100_default.wgs_qc", "--seed", "1",
                       "--seconds", "0.2", "--trace", "0"], on_card=False,
                      build=False, traffic_override={"reads": 500})
    captured = capsys.readouterr()
    assert rc == 3
    assert "humid_tpu" in captured.err
    assert captured.out == ""
