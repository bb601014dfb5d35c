"""Memory-error gate for the port's native code: the host C extensions
under AddressSanitizer, the two CUDA kernels under compute-sanitizer.

    python -m humid_tpu_torch.tools.check_native [--host] [--device]

Counterpart of the JAX package's ``scripts/check_native.sh`` and the
Makefile's ``memcheck`` target (the analogue of the reference's valgrind
step).  Without ``--host`` or ``--device`` both halves run.

**Host half.**  ``humid_tpu_torch/``, ``csrc/``, ``setup.py`` and the
testing helpers are copied to ``build/check_native/tree/`` (git-ignored)
and ``setup.py build_ext --inplace`` builds the extensions there with
``-fsanitize=address -fno-omit-frame-pointer -g -O1`` (in CFLAGS,
CXXFLAGS and LDFLAGS: setuptools compiles C++ with CXXFLAGS, so CFLAGS
alone builds them uninstrumented; every built library must hold ASan's
symbols), by the first compiler that has ASan's runtime
(:func:`asan_toolchain`; a compiler that cannot link ``-fopenmp`` builds
them without OpenMP, said on its own line).  Then, with that compiler's
libasan preloaded, ``ASAN_OPTIONS=detect_leaks=0`` (the interpreter's
own allocations live until exit) and HUMID_TPU_TORCH_DEVICE=cpu: the three
extensions must import from the copy, ``tests/test_torch_native.py``
(jax-free: each extension function against the port's fallback) must
pass with nothing skipped, and ``fuzz_oracle`` must pass FUZZ_SEEDS
(20) configs.  Without a compiler, Python's headers or a
compiler with libasan the half says so on its own line and does not run.

**Device half.**  Small cases of both kernels (:func:`k1_cases`,
:func:`k2_cases`: w = 1-3, m = 0-3, tables that are not whole tiles,
partitions with ``part_valid < part_stride`` on both of K1's staging
paths, the run-id mask, a buffer that overflows, a case where no pair
passes; K2 at b = 256 and 2,048, ``upper_only`` both ways, ``u`` cutting
a block) run under ``compute-sanitizer`` with each of ``memcheck``,
``racecheck``, ``initcheck`` and ``synccheck`` (``--error-exitcode 1``;
the binary beside ``nvcc``; PYTORCH_NO_CUDA_MEMORY_CACHING=1 so that each
tensor is its own allocation).  Each case also holds the kernel against
its plain version, so a checked run is a correct one.  Each tool's run
is classified by :func:`classify`: "0 errors", "errors", or
"unsupported" where the tool reports that it cannot attach to the card
("Device not supported"), the cases never ran, and every error its
summary counts is that message or a CUDA call failing after it.  An
"unsupported" tool checked nothing, and the line that says so says that
zero errors under it is not shown.  In every case the cases run once more in this process with guards that the card
can check itself (:func:`guarded_k1`, :func:`guarded_k2`): the table sits
between guard rows, its padding rows (and those guard rows) hold copies
of real words, the pair buffer and the counter are followed by sentinel
words.  A read of padding or of a neighbouring row that reached a result
would change the pairs; a write past the buffer, or a slot left
unwritten, shows in the sentinels.  What these guards do not see: a
read outside the table that changes nothing, and races in shared memory
(racecheck's domain).

The last line is one JSON summary; the exit code is 1 if any check found
an error or a mismatch (a sanitizer that cannot attach is not an error,
and not a pass either: its status says "unsupported").
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import sysconfig
import time
from pathlib import Path

import numpy as np

from .._device import resolve_device

REPO = Path(__file__).resolve().parents[2]
TREE = REPO / "build" / "check_native" / "tree"
ASAN_CFLAGS = "-fsanitize=address -fno-omit-frame-pointer -g -O1"
ASAN_OPTIONS = "detect_leaks=0"
#: The host half's test files (run from the copy; no jax).
HOST_TESTS = ("tests/test_torch_native.py",)
#: Files of tests/ the copy needs: the tests and their helpers.
TEST_FILES = (*HOST_TESTS, "tests/genfastq.py", "tests/oracle.py")
EXTENSIONS = ("_hostops", "io._cfastqio", "cluster._ccluster")
SANITIZER_TOOLS = ("memcheck", "racecheck", "initcheck", "synccheck")
UNSUPPORTED = "Device not supported"
#: fuzz_oracle configs the host half runs under ASan.
FUZZ_SEEDS = 20


# --------------------------------------------------------------- host half

def _asan_lib(compiler: str) -> str | None:
    path = subprocess.run([compiler, "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    return path if os.path.isabs(path) and os.path.exists(path) else None


def asan_toolchain() -> dict | None:
    """{"cc", "cxx", "libasan"} of the first compiler pair whose own
    libasan exists: the one setup.py would take ($CC/$CXX, else gcc/g++
    on the path), else the system's in /usr/bin.  A compiler without
    ASan's runtime cannot link -fsanitize=address.  None if there is
    none."""
    pairs = []
    if os.environ.get("CXX"):
        pairs.append((os.environ.get("CC", "gcc"), os.environ["CXX"]))
    for where in (None, "/usr/bin"):
        cc, cxx = (shutil.which(n, path=where) for n in ("gcc", "g++"))
        if cc and cxx:
            pairs.append((cc, cxx))
    for cc, cxx in pairs:
        lib = _asan_lib(cxx)
        if lib:
            return {"cc": cc, "cxx": cxx, "libasan": lib}
    return None


def host_toolchain_missing() -> str | None:
    """Why the host half cannot run here (no compiler, no Python headers,
    no compiler with libasan), or None."""
    if shutil.which("g++") is None and shutil.which("g++", path="/usr/bin") \
            is None:
        return "no C++ compiler (g++)"
    header = os.path.join(sysconfig.get_paths()["include"], "Python.h")
    if not os.path.exists(header):
        return f"no Python headers ({header})"
    if asan_toolchain() is None:
        return "no compiler with libasan (g++ -print-file-name=libasan.so)"
    return None


def build_env(tools: dict) -> dict:
    """The environment of the ASan build: the compiler pair of ``tools``
    for compiling and linking, the flags in CFLAGS and, for the
    setuptools releases that compile and link C++ with their own
    variables, in CXXFLAGS and LDFLAGS too."""
    return dict(os.environ, CC=tools["cc"], CXX=tools["cxx"],
                LDSHARED=f"{tools['cc']} -shared",
                LDCXXSHARED=f"{tools['cxx']} -shared", CFLAGS=ASAN_CFLAGS,
                CXXFLAGS=ASAN_CFLAGS, LDFLAGS="-fsanitize=address")


def asan_env(tree: Path, lib: str) -> dict:
    """The environment of the checks: libasan preloaded, leaks off, the
    copy first on the path, the CPU as the device."""
    env = dict(os.environ, LD_PRELOAD=lib, ASAN_OPTIONS=ASAN_OPTIONS,
               PYTHONPATH=str(tree), HUMID_TPU_TORCH_DEVICE="cpu")
    for var in ("HUMID_TPU_TORCH_STRATEGY", "HUMID_TPU_TORCH_FUSED",
                "HUMID_TPU_TORCH_SHARDS"):
        env.pop(var, None)
    return env


def _setup_py(tree: Path, env: dict) -> subprocess.CompletedProcess:
    # Serial: both packages' extensions compile the same sources to the
    # same object files.
    return subprocess.run(
        [sys.executable, "setup.py", "build_ext", "--inplace", "--force"],
        cwd=tree, env=env, capture_output=True, text=True)


def build_tree(tools: dict, tree: Path = TREE) -> dict:
    """The copy with the extensions built under ASan by the compilers of
    ``tools``: {"build_s", "openmp", "cxx"}; raises RuntimeError when the
    build fails."""
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(REPO / "humid_tpu_torch", tree / "humid_tpu_torch",
                    ignore=shutil.ignore_patterns("*.so", "__pycache__"))
    shutil.copytree(REPO / "csrc", tree / "csrc")
    shutil.copy2(REPO / "setup.py", tree)
    (tree / "tests").mkdir()
    for f in TEST_FILES:
        shutil.copy2(REPO / f, tree / f)
    # setup.py builds the JAX package's extensions too: give them their
    # directories (the copy holds no JAX package).
    for d in ("cluster", "io"):
        (tree / "humid_tpu" / d).mkdir(parents=True)
    t0 = time.perf_counter()
    proc = _setup_py(tree, build_env(tools))
    openmp = True
    if proc.returncode and "libgomp" in proc.stdout + proc.stderr:
        print("check_native host: the compiler cannot link -fopenmp (no "
              "libgomp); building without OpenMP", flush=True)
        openmp = False
        recipe = (tree / "setup.py").read_text()
        (tree / "setup.py").write_text(re.sub(r',?\s*"-fopenmp"', "",
                                              recipe))
        proc = _setup_py(tree, build_env(tools))
    if proc.returncode:
        raise RuntimeError(f"ASan build failed:\n{proc.stdout[-3000:]}"
                           f"{proc.stderr[-3000:]}")
    plain = [str(so) for so in (tree / "humid_tpu_torch").rglob("*.so")
             if b"__asan_" not in so.read_bytes()]
    if plain:
        raise RuntimeError(f"built without ASan: {plain}")
    return {"build_s": time.perf_counter() - t0, "openmp": openmp,
            "cxx": tools["cxx"]}


def _asan_run(cmd, tree: Path, env: dict, timeout: int = 1800) -> str:
    proc = subprocess.run(cmd, cwd=tree, env=env, capture_output=True,
                          text=True, timeout=timeout)
    text = proc.stdout + proc.stderr
    if proc.returncode or "AddressSanitizer" in text:
        raise RuntimeError(f"{' '.join(map(str, cmd))} exited "
                           f"{proc.returncode} under ASan:\n{text[-6000:]}")
    return proc.stdout


def host_half(tree: Path = TREE) -> dict:
    """Build, then the three checks under ASan (module docstring)."""
    why = host_toolchain_missing()
    if why:
        print(f"check_native host: not run, {why}", flush=True)
        return {"status": f"not run: {why}"}
    tools = asan_toolchain()
    out = build_tree(tools, tree)
    env = asan_env(tree, tools["libasan"])
    py = sys.executable
    t0 = time.perf_counter()
    where = _asan_run([py, "-c", "import importlib; print(*(importlib."
                       "import_module('humid_tpu_torch.' + n).__file__ "
                       f"for n in {EXTENSIONS!r}))"], tree, env).split()
    if len(where) != len(EXTENSIONS) or not all(
            p.startswith(str(tree)) for p in where):
        raise RuntimeError(f"the extensions did not load from {tree}: "
                           f"{where}")
    # -s: an ASan report goes to fd 2, which pytest would capture and
    # lose when ASan aborts the process.
    tests = _asan_run([py, "-m", "pytest", "-p", "no:cacheprovider", "-q",
                       "-s", "-rs", *HOST_TESTS], tree, env)
    summary = tests.strip().splitlines()[-1]
    if "skipped" in summary or "passed" not in summary:
        raise RuntimeError(f"host tests under ASan: {summary}\n{tests}")
    fuzz = _asan_run([py, "-m", "humid_tpu_torch.tools.fuzz_oracle",
                      str(FUZZ_SEEDS), "--device", "cpu"], tree, env)
    fuzz_summary = json.loads(fuzz.strip().splitlines()[-1])
    out.update(status="passed", tests=summary,
               fuzz={k: fuzz_summary[k] for k in (
                   "configs", "failures", "engines", "seconds")},
               checks_s=time.perf_counter() - t0, asan_options=ASAN_OPTIONS)
    print(f"check_native host: {json.dumps(out)}", flush=True)
    return out


# ------------------------------------------------------------- device half

def _words(rng, n: int, length: int, pool: int, subst: int) -> np.ndarray:
    """[n, w] packed words (not unique, not sorted) of ``length`` bases
    from ``pool`` sequences with up to ``subst`` substitutions each, so
    that every distance up to ``subst`` occurs."""
    from .. import words as W

    base = rng.integers(0, 4, (pool, length), dtype=np.uint8)
    codes = base[rng.integers(0, pool, n)]
    for _ in range(subst):
        hit = np.flatnonzero(rng.random(n) < 0.5)
        codes[hit, rng.integers(0, length, len(hit))] = rng.integers(
            0, 4, len(hit), dtype=np.uint8)
    return W.pack_words(codes)


def _upper_tile_pairs(n_tiles: int) -> np.ndarray:
    ii, jj = np.triu_indices(n_tiles)
    tp = np.ones((len(ii), 3), np.int32)
    tp[:, 0], tp[:, 1] = ii, jj
    tp[::5, 2] = 0  # some tile pairs switched off
    return tp


def k1_cases() -> list[dict]:
    """The tile sweep's small cases: (name, rows [N, w] uint32, tile
    pairs [nb, 3], tile, part_stride, part_valid, max_dist, ids)."""
    cases = []
    rng = np.random.default_rng(2024)
    for length in (16, 24, 40):  # w = 1, 2, 3
        for m in range(4):
            # u = 700 in tiles of 256: a table that is not whole tiles.
            rows = _words(rng, 768, length, 60, max(m, 1))
            cases.append(dict(name=f"L{length}_m{m}_u700", rows=rows,
                              tile_pairs=_upper_tile_pairs(3), tile=256,
                              part_stride=768, part_valid=700, max_dist=m,
                              ids=None))
    rows = _words(rng, 3 * 512, 24, 80, 2)
    ids = rng.integers(0, 4, len(rows)).astype(np.int32)
    for ids_on in (False, True):
        tag = "_ids" if ids_on else ""
        # Prefix staging (part_stride a multiple of the tile) ...
        cases.append(dict(name=f"parts_prefix{tag}", rows=rows,
                          tile_pairs=_upper_tile_pairs(6), tile=256,
                          part_stride=512, part_valid=300, max_dist=2,
                          ids=ids if ids_on else None))
        # ... and the per-index test (it is not).
        cases.append(dict(name=f"parts_indexed{tag}", rows=rows[:1280],
                          tile_pairs=_upper_tile_pairs(5), tile=256,
                          part_stride=320, part_valid=250, max_dist=2,
                          ids=ids[:1280] if ids_on else None))
    distinct = np.unique(rng.integers(0, 2**32, (2000, 2), dtype=np.uint64)
                         .astype(np.uint32), axis=0)
    cases.append(dict(name="no_pair", rows=distinct[:1000],
                      tile_pairs=_upper_tile_pairs(4), tile=256,
                      part_stride=1024, part_valid=1000, max_dist=0,
                      ids=None))
    return cases


def k2_cases() -> list[dict]:
    """The ring step's small cases: (name, rows, cols [b, w] uint32,
    row_base, col_base, u, max_dist, upper_only)."""
    cases = []
    rng = np.random.default_rng(77)
    for b in (256, 2048):
        for length, m in ((24, 1), (40, 2)):
            table = _words(rng, 2 * b, length, b // 8, m)
            cases.append(dict(name=f"b{b}_L{length}_upper", rows=table[:b],
                              cols=table[:b], row_base=0, col_base=0,
                              u=b - 37, max_dist=m, upper_only=True))
            cases.append(dict(name=f"b{b}_L{length}_cross", rows=table[:b],
                              cols=table[b:], row_base=0, col_base=b,
                              u=2 * b - 100, max_dist=m, upper_only=False))
    return cases


def _t(array: np.ndarray, device):
    import torch

    return torch.from_numpy(np.ascontiguousarray(array).view(np.int32)).to(
        device)


def _same(name: str, got, want) -> None:
    ga, gb = (x.cpu().numpy() for x in got)
    wa, wb = (x.cpu().numpy() for x in want)
    if not (np.array_equal(ga, wa) and np.array_equal(gb, wb)):
        raise AssertionError(f"{name}: {len(ga)} pairs, the plain version "
                             f"{len(wa)}")


def _k1_kw(c: dict) -> dict:
    return {k: c[k] for k in ("tile", "part_stride", "part_valid",
                              "max_dist")}


GUARD_ROWS = 64
SENTINEL = -7


def _poisoned(rows: np.ndarray, bad: np.ndarray, device):
    """[G + N + G, w] store whose guard rows and ``bad`` rows hold copies
    of real rows (cyclically), and the [N, w] view of the table in it."""
    import torch

    n = len(rows)
    donors = rows[np.arange(GUARD_ROWS * 2 + n) % max(n, 1)]
    store = donors.copy()
    inner = store[GUARD_ROWS:GUARD_ROWS + n]
    inner[:] = rows
    inner[bad] = rows[(np.flatnonzero(bad) * 7 + 3) % n]
    store_t = _t(store, device)
    return store_t, store_t[GUARD_ROWS:GUARD_ROWS + n]


def _guarded_buffers(cap: int, words: int, device):
    """Key buffer [cap] and counter [words] (zeros), each followed by
    sentinel words."""
    import torch

    keys = torch.full((cap + GUARD_ROWS,), SENTINEL, dtype=torch.int64,
                      device=device)
    counter = torch.full((words + 8,), SENTINEL, dtype=torch.int64,
                         device=device)
    counter[:words] = 0
    return keys, counter


def _check_guards(name, keys, counter, words, cap, n_want,
                  want_keys) -> None:
    n_slots = min(cap, n_want)
    k = keys.cpu().numpy()
    ctr = counter.cpu().numpy()
    if not (ctr[words:] == SENTINEL).all():
        raise AssertionError(f"{name}: a write past the counter")
    if not (k[cap:] == SENTINEL).all():
        raise AssertionError(f"{name}: a write past the key buffer "
                             f"(capacity {cap})")
    if ctr[0] != n_want:
        raise AssertionError(f"{name}: counted {ctr[0]}, want {n_want}")
    written = k[:n_slots]
    if (written == SENTINEL).any() or not (k[n_slots:cap] == SENTINEL).all():
        raise AssertionError(f"{name}: slots below the count left unwritten "
                             f"or slots above it written")
    if cap >= n_want and not np.array_equal(np.sort(written), want_keys):
        raise AssertionError(f"{name}: keys differ from the plain version's")
    if cap < n_want and not np.isin(written, want_keys).all():
        raise AssertionError(f"{name}: an overflowing launch wrote keys "
                             f"that are not pairs")


def guarded_k1(c: dict, device) -> int:
    """One K1 case through a direct launch with poisoned padding and guard
    rows, guarded buffers, at the exact capacity and at half of it;
    returns the pair count."""
    import torch

    from ..ops import cuda_hamming as H

    rows = c["rows"]
    n = len(rows)
    idx = np.arange(n)
    bad = idx % c["part_stride"] >= c["part_valid"]
    tp = torch.from_numpy(c["tile_pairs"])
    ids_cpu = None if c["ids"] is None else torch.from_numpy(c["ids"])
    a, b = H.hamming_tile_pairs_plain(_t(rows, "cpu"), tp, ids=ids_cpu,
                                      **_k1_kw(c))
    want = np.sort((a * n + b).numpy())
    _, lanes = _poisoned(rows, bad, device)
    ids = None if ids_cpu is None else ids_cpu.to(device)
    for cap in (len(want), len(want) // 2):
        keys, counter = _guarded_buffers(cap, 2, device)
        H._launch(lanes, tp.to(device), keys[:cap], counter[:2], ids=ids,
                  **_k1_kw(c))
        torch.cuda.synchronize(device)
        if counter[1].item():
            raise AssertionError(f"K1 {c['name']}: bad-tile-pair flag set")
        _check_guards(f"K1 {c['name']} (capacity {cap})", keys, counter, 2,
                      cap, len(want), want)
    return len(want)


def guarded_k2(c: dict, device) -> int:
    """One K2 step through a direct launch: each block's rows past u and
    the guard rows poisoned, guarded buffers at the exact capacity and at
    half of it; returns the pair count."""
    import torch

    from ..parallel import cuda_ring as R

    b = len(c["rows"])
    kw = {k: c[k] for k in ("row_base", "col_base", "u", "max_dist",
                            "upper_only")}
    a, bb = R.ring_block_pairs_plain(_t(c["rows"], "cpu"),
                                     _t(c["cols"], "cpu"), **kw)
    want = np.sort((a * max(c["u"], 1) + bb).numpy())
    blocks = []
    for name, base in (("rows", c["row_base"]), ("cols", c["col_base"])):
        bad = base + np.arange(b) >= c["u"]
        blocks.append(_poisoned(c[name], bad, device)[1])
    for cap in (len(want), len(want) // 2):
        keys, counter = _guarded_buffers(cap, 1, device)
        R._step(blocks[0], blocks[1], R._PairBuffer(keys[:cap], counter[:1]),
                **kw)
        torch.cuda.synchronize(device)
        _check_guards(f"K2 {c['name']} (capacity {cap})", keys, counter, 1,
                      cap, len(want), want)
    return len(want)


def run_kernel_cases(device, guards: bool | None = None) -> dict:
    """Every case through the public wrapper against the plain version
    (K1 once more with the first capacity shrunk to 16 pairs, so that it
    overflows and relaunches), and with ``guards`` (default: on a card)
    through the guarded direct launches.  Returns counts per kernel;
    raises on a mismatch."""
    import torch

    if guards is None:
        guards = device.type == "cuda"
    from ..ops import cuda_hamming as H
    from ..parallel import cuda_ring as R

    out = {"hamming_sweep": {"cases": 0, "pairs": 0, "relaunches": 0},
           "ring_sweep": {"cases": 0, "pairs": 0}}
    k1 = out["hamming_sweep"]
    for c in k1_cases():
        tp = torch.from_numpy(c["tile_pairs"])
        ids = None if c["ids"] is None else torch.from_numpy(c["ids"])
        want = H.hamming_tile_pairs_plain(_t(c["rows"], "cpu"), tp, ids=ids,
                                          **_k1_kw(c))
        dev_ids = None if ids is None else ids.to(device)
        got = H.hamming_tile_pairs(_t(c["rows"], device), tp.to(device),
                                   ids=dev_ids, **_k1_kw(c))
        _same(f"K1 {c['name']}", got, want)
        cap0, H.CAP_START = H.CAP_START, 16
        try:
            before = H.LAUNCHES
            got = H.hamming_tile_pairs(_t(c["rows"], device), tp.to(device),
                                       ids=dev_ids, **_k1_kw(c))
            k1["relaunches"] += max(H.LAUNCHES - before - 1, 0)
        finally:
            H.CAP_START = cap0
        _same(f"K1 {c['name']} (first capacity 16)", got, want)
        if guards:
            guarded_k1(c, device)
        k1["cases"] += 1
        k1["pairs"] += len(want[0])
    k2 = out["ring_sweep"]
    for c in k2_cases():
        kw = {k: c[k] for k in ("row_base", "col_base", "u", "max_dist",
                                "upper_only")}
        want = R.ring_block_pairs_plain(_t(c["rows"], "cpu"),
                                        _t(c["cols"], "cpu"), **kw)
        got = R.ring_block_pairs(_t(c["rows"], device),
                                 _t(c["cols"], device), **kw)
        _same(f"K2 {c['name']}", got, want)
        if guards:
            guarded_k2(c, device)
        k2["cases"] += 1
        k2["pairs"] += len(want[0])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"check_native kernel cases on {device}: {json.dumps(out)}",
          flush=True)
    return out


def sanitizer_path() -> Path:
    """compute-sanitizer beside nvcc."""
    from .. import _build

    return Path(_build._nvcc()).with_name("compute-sanitizer")


def sanitizer_cmd(tool: str, binary: str | None = None) -> list[str]:
    """The kernel cases (``--cases``) under ``tool``."""
    return [binary or str(sanitizer_path()), "--tool", tool,
            "--error-exitcode", "1",
            sys.executable, "-m", "humid_tpu_torch.tools.check_native",
            "--cases"]


def _records(text: str) -> list[str]:
    """The heads of compute-sanitizer's records in ``text``: its lines
    (``=========`` first) that are neither a record's indented
    continuation, nor its banner, nor a summary."""
    heads = []
    for line in text.splitlines():
        if not line.startswith("========= ") or line.startswith(
                "=========  "):
            continue
        head = line[len("========= "):].strip()
        if head and head != "COMPUTE-SANITIZER" and "SUMMARY" not in head:
            heads.append(head)
    return heads


def classify(text: str, returncode: int) -> dict:
    """One compute-sanitizer run's output and exit code -> {"status":
    "0 errors" | "unsupported" | "errors", "summary", "records"}.

    "0 errors": it exited 0, the kernel cases ran to their end, its
    summary counts no error and it did not say "Device not supported".
    "unsupported": it said so, the cases never ran to their end, and
    every error its summary counts is that message or a CUDA call that
    failed after it ("Program hit cudaError..."): the tool checked
    nothing.  Anything else is "errors"."""
    summaries = [ln.strip("= ").strip() for ln in text.splitlines()
                 if ln.startswith("=========") and "SUMMARY" in ln]
    summary = summaries[-1] if summaries else None
    counted = re.search(r"(\d+) errors?\b", summary or "")
    n_errors = int(counted.group(1)) if counted else None
    records = _records(text)
    cases_ran = "cases on" in text
    rec = {"summary": summary, "records": records[:12]}
    explained = [r for r in records
                 if UNSUPPORTED in r or r.startswith("Program hit cudaError")]
    if any(UNSUPPORTED in r for r in records) and not cases_ran \
            and n_errors is not None and n_errors <= len(explained):
        rec["status"] = "unsupported"
        rec["reason"] = next(r for r in records if UNSUPPORTED in r)
    elif returncode == 0 and cases_ran and n_errors == 0 \
            and UNSUPPORTED not in text:
        rec["status"] = "0 errors"
    else:
        rec["status"] = "errors"
    return rec


def sanitize(tool: str) -> dict:
    """The kernel cases under one compute-sanitizer tool:
    :func:`classify`'s record, with "seconds" and, for "errors", the
    output's end."""
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    t0 = time.perf_counter()
    proc = subprocess.run(sanitizer_cmd(tool), cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=1200)
    text = proc.stdout + proc.stderr
    rec = classify(text, proc.returncode)
    rec["seconds"] = time.perf_counter() - t0
    if rec["status"] == "errors":
        rec["output"] = text[-6000:]
    return rec


def device_half(device) -> dict:
    """compute-sanitizer's four tools over the kernel cases, then the
    guarded cases in this process (module docstring)."""
    from .. import _build

    _build.build_all(("hamming_sweep", "ring_sweep"))
    tools = {}
    for tool in SANITIZER_TOOLS:
        tools[tool] = sanitize(tool)
        rec = {k: v for k, v in tools[tool].items() if k != "output"}
        print(f"check_native compute-sanitizer {tool}: {json.dumps(rec)}",
              flush=True)
        if tools[tool]["status"] == "errors":
            print(tools[tool]["output"], flush=True)
    unsupported = [t for t, r in tools.items() if r["status"] == "unsupported"]
    if unsupported:
        print(f"check_native device: NOT CHECKED: compute-sanitizer cannot "
              f"attach to this card ({tools[unsupported[0]]['reason']}); "
              f"zero errors under {', '.join(unsupported)} is not shown, "
              f"only the guard checks below ran", flush=True)
    t0 = time.perf_counter()
    cases = run_kernel_cases(device, guards=True)
    return {"sanitizer": tools, "unchecked": unsupported,
            "guarded_cases": cases,
            "guarded_s": time.perf_counter() - t0,
            "errors": sum(r["status"] == "errors" for r in tools.values())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--host", action="store_true", help="the ASan half only")
    p.add_argument("--device", action="store_true",
                   help="the compute-sanitizer half only")
    p.add_argument("--cases", action="store_true",
                   help="only run the kernel cases against their plain "
                        "versions (what compute-sanitizer runs)")
    args = p.parse_args(argv)
    if args.cases:
        run_kernel_cases(resolve_device(), guards=False)
        return 0
    both = not (args.host or args.device)
    # Resolved first: without a card the device half raises at once.
    device = resolve_device("cuda") if args.device or both else None
    summary = {}
    if args.host or both:
        summary["host"] = host_half()
    if device is not None:
        summary["device"] = device_half(device)
    print(json.dumps(summary), flush=True)
    return 1 if summary.get("device", {}).get("errors") else 0


if __name__ == "__main__":
    sys.exit(main())
