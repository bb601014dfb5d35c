"""The port's counterparts of the JAX package's four hunting and gating
tools (``scripts/fuzz_oracle.py``, ``fuzz_multiproc.py``,
``engine_xover.py``, ``check_native.sh``) on the CPU at small sizes:
``humid_tpu_torch.tools.fuzz_oracle``, ``fuzz_multiproc``,
``engine_xover`` and ``check_native``.

Everything compared is integers, strings or bytes: exact equality.
"""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from humid_tpu_torch.io.names import make_file_name
from humid_tpu_torch.tools import check_native as CN
from humid_tpu_torch.tools import engine_xover as X
from humid_tpu_torch.tools import fuzz_multiproc as FM
from humid_tpu_torch.tools import fuzz_oracle as FO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


# The reference's loop body of scripts/fuzz_oracle.py (from
# ``rng = np.random.default_rng(seed)`` up to its ``env_backup`` line),
# executed for each seed with numpy's default_rng, with its draws read off
# its variables (``cluster_route`` as ``cluster``) and ``next`` the
# generator's following ``integers(0, 2**30)``: the values the dataset
# generator then starts from.
REFERENCE_DRAWS = {
    10000: (dict(cfg=dict(n_files=1, umi_style="underscore", gz=False,
                          distance=2, word_length=22, edit=False,
                          maximum=True, ragged=False, unequal=False,
                          n_reads=126, batch_records=524288),
                 span=True, strategy=None, overlap=False, fused=False,
                 cluster="device", edit_verify=None), 236362082),
    10010: (dict(cfg=dict(n_files=2, umi_style="none", gz=False,
                          distance=2, word_length=29, edit=True,
                          maximum=False, ragged=True, unequal=False,
                          n_reads=478, batch_records=524288),
                 span=False, strategy=None, overlap=False, fused=True,
                 cluster=None, edit_verify=None), 557271583),
    10016: (dict(cfg=dict(n_files=3, umi_style="none", gz=False,
                          distance=2, word_length=9, edit=True,
                          maximum=False, ragged=False, unequal=False,
                          n_reads=173, batch_records=1024, pool_size=2),
                 span=True, strategy="sharded", overlap=False, fused=False,
                 cluster=None, edit_verify="host"), 893384201),
}


@pytest.mark.parametrize("seed", sorted(REFERENCE_DRAWS))
def test_draw_config_is_the_references(seed):
    want, nxt = REFERENCE_DRAWS[seed]
    case, rng = FO.draw_config(seed)
    assert case == want
    assert int(rng.integers(0, 1 << 30)) == nxt
    assert FO.not_ported(case) == (["edit_verify=host"] if seed == 10016
                                   else [])
    env = FO.case_env(case, 8)
    assert env["HUMID_TPU_TORCH_SHARDS"] == "8"
    assert env["HUMID_TPU_TORCH_STRATEGY"] == case["strategy"]
    assert env["HUMID_TPU_TORCH_FUSED"] == ("1" if case["fused"] else None)
    assert env["HUMID_TPU_TORCH_CLUSTER"] == (
        "device" if case["cluster"] == "device" else None)


#: Seeds of 10,000-10,099 that together force every strategy (auto
#: included), the fused route (10061 runs it; 10028 draws it with -e, which
#: ignores it), device directional clustering and -e.
COVERING_SEEDS = [10061, 10028, 10042, 10034, 10022, 10097, 10052, 10053]


def test_fuzz_oracle_main_covers_every_dimension():
    out = FO.campaign(COVERING_SEEDS, torch.device("cpu"))
    assert out["configs"] == len(COVERING_SEEDS) and out["failures"] == 0
    assert set(out["strategies"]) == {"auto", *FO.STRATEGIES[1:]}
    assert out["engines"].get("fused", 0) >= 1
    assert out["routes"]["cluster_device"] >= 1
    assert out["routes"]["edit"] >= 1
    # The plain versions run on the CPU: no kernel launch.
    assert out["launches"] == {"hamming_sweep": 0, "ring_sweep": 0}


def test_fuzz_oracle_main_passes_a_seed_range(capsys):
    """``N SEED`` from the command line: seeds 10052 and 10053 (both of
    the covering list), exit 0 and the JSON summary last."""
    assert FO.main(["2", "10052", "--device", "cpu"]) == 0
    out = _last_json(capsys.readouterr().out)
    assert out["configs"] == 2 and out["failures"] == 0
    assert out["failed_seeds"] == [] and out["device"] == "cpu"


def test_fuzz_oracle_reports_a_dropped_record(monkeypatch, capsys):
    """A run that loses one dedup record fails its case: exit 1, the seed
    and the traceback printed."""
    real = FO.run

    def drops_a_record(files, **kw):
        res = real(files, **kw)
        path = make_file_name(files[0], kw["dir_name"], "dedup")
        with open(path) as fh:
            lines = fh.readlines()
        with open(path, "w") as fh:
            fh.writelines(lines[:-4])
        return res

    monkeypatch.setattr(FO, "run", drops_a_record)
    assert FO.main(["1", "10052", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "seed=10052 FAIL" in out and "dedup mismatch file 0" in out
    assert _last_json(out)["failed_seeds"] == [10052]


def test_fuzz_multiproc_two_processes(capsys):
    """Seed 42000 draws two processes; both CLI processes on the CPU must
    write the in-process run's bytes."""
    _, flags, n_proc, _ = FM.draw_config(np.random.default_rng(42000))
    assert n_proc == 2 and flags[:2] == ["-m", "0"]
    assert FM.main(["1", "42000", "--device", "cpu"]) == 0
    out = _last_json(capsys.readouterr().out)
    assert out["failures"] == 0 and len(out["seconds_per_config"]) == 1


@pytest.mark.parametrize("u", [4096, 16384])
def test_gen_uniques_is_the_references(u):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import engine_xover as ref
    finally:
        sys.path.pop(0)
    np.testing.assert_array_equal(X.gen_uniques(u), ref.gen_uniques(u))
    for got, want in zip(X.gen_uniques(u, return_reads=True),
                         ref.gen_uniques(u, return_reads=True)):
        np.testing.assert_array_equal(got, want)


def test_engine_xover_main_one_line_per_engine(capsys):
    assert X.main(["--sizes", "4096", "--runs", "1", "--device",
                   "cpu"]) == 0
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    engines = [ln for ln in lines if "engine" in ln]
    assert [ln["engine"] for ln in engines] == list(
        X.TABLE_ENGINES + X.WHOLE_ENGINES)
    assert len({ln.get("table_pairs", ln["pairs"]) for ln in engines}) == 1
    assert all(ln["u"] == 4096 for ln in engines[:4])
    assert all(ln["backend"] == "cpu" and ln["card"] is None
               for ln in engines)
    assert lines[0]["u"] == 4096 and lines[0]["n_reads"] == 3 * 4096


def test_restrict_renumbers_into_the_subsample():
    pairs = (np.array([0, 1, 1, 3]), np.array([2, 3, 4, 4]))
    a, b = X.restrict(pairs, np.array([1, 3, 4]), 5)
    assert a.tolist() == [0, 0, 1] and b.tolist() == [1, 2, 2]
    a, b = X.restrict(pairs, None, 5)
    assert a.tolist() == [0, 1, 1, 3] and b.tolist() == [2, 3, 4, 4]


def test_check_native_flags_and_environment(tmp_path):
    env = CN.build_env({"cc": "/usr/bin/gcc", "cxx": "/usr/bin/g++",
                        "libasan": "/lib/libasan.so"})
    assert (env["CC"], env["CXX"]) == ("/usr/bin/gcc", "/usr/bin/g++")
    assert env["LDCXXSHARED"] == "/usr/bin/g++ -shared"
    for var in ("CFLAGS", "CXXFLAGS"):
        assert env[var] == ("-fsanitize=address -fno-omit-frame-pointer "
                            "-g -O1")
    assert "-fsanitize=address" in env["LDFLAGS"]
    run_env = CN.asan_env(tmp_path, "/lib/libasan.so")
    assert run_env["LD_PRELOAD"] == "/lib/libasan.so"
    assert run_env["ASAN_OPTIONS"] == "detect_leaks=0"
    assert run_env["HUMID_TPU_TORCH_DEVICE"] == "cpu"
    assert run_env["PYTHONPATH"] == str(tmp_path)
    cmd = CN.sanitizer_cmd("racecheck", "/cuda/bin/compute-sanitizer")
    assert cmd[:5] == ["/cuda/bin/compute-sanitizer", "--tool", "racecheck",
                       "--error-exitcode", "1"]
    assert cmd[-2:] == ["humid_tpu_torch.tools.check_native", "--cases"]
    assert set(CN.SANITIZER_TOOLS) == {"memcheck", "racecheck", "initcheck",
                                       "synccheck"}


def test_check_native_test_files_import_no_jax():
    banned = re.compile(r"^\s*(import|from)\s+(jax|humid_tpu)\b", re.M)
    for name in CN.TEST_FILES:
        with open(os.path.join(REPO, name)) as fh:
            assert not banned.search(fh.read()), name
    assert "tests/test_torch_native.py" in CN.HOST_TESTS


def test_check_native_kernel_cases_cover_the_edges():
    """The small shapes of the device half, and the cases themselves
    through the wrappers on the CPU (the plain versions)."""
    k1 = CN.k1_cases()
    assert {c["rows"].shape[1] for c in k1} == {1, 2, 3}
    assert {c["max_dist"] for c in k1} == {0, 1, 2, 3}
    assert any(c["part_valid"] % c["tile"] for c in k1)
    assert any(c["part_stride"] % c["tile"] == 0
               and c["part_valid"] < c["part_stride"] for c in k1)
    assert any(c["part_stride"] % c["tile"] for c in k1)
    assert any(c["ids"] is not None for c in k1)
    k2 = CN.k2_cases()
    assert {len(c["rows"]) for c in k2} == {256, 2048}
    assert {c["upper_only"] for c in k2} == {True, False}
    assert all(c["u"] < c["col_base"] + len(c["cols"]) for c in k2)
    out = CN.run_kernel_cases(torch.device("cpu"))
    assert out["hamming_sweep"]["cases"] == len(k1)
    assert out["ring_sweep"]["cases"] == len(k2)
    assert out["hamming_sweep"]["pairs"] > 0
    assert out["ring_sweep"]["pairs"] > 0
    no_pair = next(c for c in k1 if c["name"] == "no_pair")
    from humid_tpu_torch.ops.cuda_hamming import hamming_tile_pairs_plain
    a, _ = hamming_tile_pairs_plain(
        CN._t(no_pair["rows"], "cpu"),
        torch.from_numpy(no_pair["tile_pairs"]), **CN._k1_kw(no_pair))
    assert len(a) == 0


def test_many_chunk_sweep_holds_only_its_matches(monkeypatch):
    """Found by engine_xover on the card: ``dense`` at 2^23 uniques (2,049
    chunks of tile pairs) ran out of the H100's 80 GB, because each
    chunk's keys were kept as a slice of its whole CAP_START buffer.  Here
    with 1-pair chunks on the CPU: what reaches the final concatenation
    must hold the matches' bytes, not one buffer a chunk."""
    from humid_tpu_torch.ops import cuda_hamming as H

    rows = CN._words(np.random.default_rng(5), 1024, 24, 40, 1)
    lanes = CN._t(rows, "cpu")
    tp = torch.from_numpy(CN._upper_tile_pairs(8)[:, :2].copy())
    tp = torch.cat([tp, torch.ones(len(tp), 1, dtype=torch.int32)], 1)
    kw = dict(tile=128, part_stride=1024, part_valid=1024, max_dist=1)
    want = H.hamming_tile_pairs(lanes, tp, **kw)
    held = []

    class Spy:
        def __getattr__(self, name):
            return getattr(torch, name)

        def cat(self, tensors, *a, **k):
            held.append(sum(t.untyped_storage().nbytes() for t in tensors))
            return torch.cat(tensors, *a, **k)

    monkeypatch.setattr(H, "CHUNK_PAIRS", 1)
    monkeypatch.setattr(H, "torch", Spy())
    got = H.hamming_tile_pairs(lanes, tp, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert len(tp) == 36 and len(want[0]) > 0
    # The last concatenation is the chunks' (the plain version's own come
    # before it).
    assert held[-1] == 8 * len(want[0])


_NOT_SUPPORTED = ('========= Error: Device not supported. Please refer to the '
                  '"Supported Devices" section of the sanitizer documentation')
_CASES_LINE = ('check_native kernel cases on cuda: {"hamming_sweep": '
               '{"cases": 17}, "ring_sweep": {"cases": 8}}')
_APP_FAILED = ("Traceback (most recent call last):\n"
               "torch.AcceleratorError: CUDA error: unknown error\n")

def _api_error(call: str) -> str:
    return (f'========= Program hit cudaErrorUnknown (error 999) due to '
            f'"unknown error" on CUDA API call to {call}.\n'
            "=========     Saved host backtrace up to driver entry point at "
            "error\n=========         Host Frame: _t in check_native.py:326\n"
            "========= \n")


#: compute-sanitizer outputs, each with its exit code and the status it
#: must get.  The "Device not supported" runs are those of compute-sanitizer
#: 2025.2.1 on an NVIDIA H100 80GB HBM3 (700 W) around ``check_native
#: --cases``, whose first CUDA call then failed; host backtraces cut.
SANITIZER_RUNS = {
    "clean_memcheck": (f"========= COMPUTE-SANITIZER\n{_CASES_LINE}\n"
                       "========= ERROR SUMMARY: 0 errors\n", 0, "0 errors"),
    "clean_racecheck": (f"========= COMPUTE-SANITIZER\n{_CASES_LINE}\n"
                        "========= RACECHECK SUMMARY: 0 hazards displayed "
                        "(0 errors, 0 warnings)\n", 0, "0 errors"),
    "unsupported_memcheck": (
        f"========= COMPUTE-SANITIZER\n{_NOT_SUPPORTED}\n========= \n"
        f"{_api_error('cudaMalloc')}{_api_error('cudaGetLastError')}"
        f"{_APP_FAILED}\n========= Target application returned an error\n"
        "========= ERROR SUMMARY: 3 errors\n", 1, "unsupported"),
    "unsupported_initcheck": (
        f"========= COMPUTE-SANITIZER\n{_NOT_SUPPORTED}\n========= \n"
        f"{_APP_FAILED}\n========= Target application returned an error\n"
        "========= ERROR SUMMARY: 1 error\n", 1, "unsupported"),
    "unsupported_racecheck": (
        f"========= COMPUTE-SANITIZER\n{_NOT_SUPPORTED}\n========= \n"
        f"{_APP_FAILED}\n========= Error: process didn't terminate "
        "successfully\n=========     The application may have hit an error "
        "when dereferencing Unified Memory from the host. Please rerun the "
        "application under cuda-gdb or a host debugger to catch host side "
        "errors.\n========= Target application returned an error\n"
        "========= RACECHECK SUMMARY: 1 hazard displayed (1 error, 0 "
        "warnings)\n", 1, "unsupported"),
    # The message and an API error with no reason in it: one error more
    # than the message explains.
    "unsupported_api_error_and_a_write": (
        f"========= COMPUTE-SANITIZER\n{_NOT_SUPPORTED}\n"
        f"{_api_error('cudaMalloc')}{_APP_FAILED}"
        "========= Invalid __global__ write of size 8 bytes\n"
        "========= ERROR SUMMARY: 3 errors\n", 1, "errors"),
    # The message and a real finding: the summary counts more errors than
    # the message explains.
    "unsupported_and_a_read": (
        f"========= COMPUTE-SANITIZER\n{_NOT_SUPPORTED}\n"
        "========= Invalid __global__ read of size 4 bytes\n"
        "=========     at sweep_kernel+0x1a0\n"
        f"{_APP_FAILED}========= ERROR SUMMARY: 2 errors\n", 1, "errors"),
    "a_read": (
        f"========= COMPUTE-SANITIZER\n"
        "========= Invalid __global__ read of size 4 bytes\n"
        "=========     at sweep_kernel+0x1a0\n"
        f"{_CASES_LINE}\n========= ERROR SUMMARY: 1 error\n", 1, "errors"),
    "a_race": (
        f"========= COMPUTE-SANITIZER\n========= Error: Race reported "
        "between Write access at sweep_kernel+0x2c0\n"
        f"{_CASES_LINE}\n========= RACECHECK SUMMARY: 1 hazard displayed "
        "(1 error, 0 warnings)\n", 1, "errors"),
    # The cases did not reach their end: nothing was shown clean.
    "cases_cut": ("========= COMPUTE-SANITIZER\n"
                  "========= ERROR SUMMARY: 0 errors\n", 0, "errors"),
    "no_summary": (f"{_CASES_LINE}\n", 0, "errors"),
}


@pytest.mark.parametrize("name", sorted(SANITIZER_RUNS))
def test_check_native_classifies_sanitizer_output(name):
    text, rc, want = SANITIZER_RUNS[name]
    rec = CN.classify(text, rc)
    assert rec["status"] == want, rec
    if want == "unsupported":
        assert "Device not supported" in rec["reason"]
    if name == "unsupported_and_a_read":
        assert "Invalid __global__ read of size 4 bytes" in rec["records"]
