"""One run of one benchmark cell of ``humid_tpu_torch``.

    python benchmark/run.py --workload <config>.<traffic> --seed N
                            --seconds S --trace 0|1

Set-up: build the host extensions (``python setup.py build_ext
--inplace``) and require them; make the cell's FastQ files from the seed
in a child process (cached per cell and seed under ``benchmark/.cache``);
apply the program settings that the configuration and the traffic state
(``environment``: a cell states its route there); where the router's
calibration is left on, let a child process make the router's choices at
the cell's size (its calibration, in a file there, is then measured or
refreshed outside the measured process); run one untimed
``humid_tpu_torch.run`` on the files.  Window: ``run`` back to back on the
files with the configuration's flags for S seconds.  Then the program's
outputs are judged against the plain NumPy HUMID in
``benchmark/reference`` (which follows the configuration's ``edit``;
a configuration with a flag the reference does not model is refused
before anything is made) and one JSON line is printed (``--trace 0``: the
end-to-end metrics; ``--trace 1``: the per-layer metrics, read by the
readers in ``benchmark/metrics`` from the phase timers and a profiled
slice of iterations taken after the window).

Everything a cell is made of is found by name: ``BENCHMARK.json`` at the
checkout's root names the configuration and the traffic, which are
``benchmark/configs/<config>.json`` and ``benchmark/traffic/<traffic>.json``,
and each per-layer metric is ``benchmark/metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
GENERATOR = os.path.join(HERE, "pbench", "generate.py")
#: Top-level module names that may not be loaded in a run.
FORBIDDEN = {"jax", "jaxlib", "flax", "humid_tpu"}
#: The host extensions of the port, which every run requires.
EXTENSIONS = ("humid_tpu_torch._hostops", "humid_tpu_torch.cluster._ccluster",
              "humid_tpu_torch.io._cfastqio")
#: Iterations whose whole results (not only their statistics files) are
#: kept for the comparison: drawn from the seed, uniformly over the window.
SAMPLED = 2
#: Samples (FastQ files of one cell and seed) kept in the cache: the six
#: seeds of a set of runs, so that a second set with the same seeds makes
#: no file again.
KEEP_SAMPLES = 6
#: Iterations in the profiled slice of a ``--trace 1`` run.
PROFILED = 3
STAT_FILES = ("counts.dat", "neigh.dat", "clusters.dat", "stats.dat")
#: The configuration's ``run`` flags that the reference models (and passes
#: on), or that change no number compared.
JUDGED_FLAGS = {"word_length", "distance", "edit", "run_stats",
                "write_dedup", "write_annotated"}


def log(*parts) -> None:
    print("#", *parts, file=sys.stderr, flush=True)


def process_age_s() -> float | None:
    """Seconds since this process started (``/proc/self/stat``)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError):
        return None


def proc_io() -> dict:
    try:
        with open("/proc/self/io") as f:
            return {k: int(v) for k, v in
                    (line.split(":") for line in f if ":" in line)}
    except OSError:
        return {}


def vm_hwm_bytes() -> int:
    """The process's peak resident set: the larger of ``VmHWM`` in
    ``/proc/self/status`` and ``getrusage``'s ``ru_maxrss`` (some kernels
    report one of them as 0)."""
    hwm = 0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    hwm = int(line.split()[1]) * 1024
    except OSError:
        pass
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return max(hwm, rss)


def host_sample() -> tuple:
    """(this process's CPU seconds, its resident bytes): read between
    iterations, so that a drift within the window shows whether the same
    work took more CPU time (a slower or busier host) or the process grew.
    (The chip machine's kernel reports no steal time, page faults or
    context switches: they read 0 there.)"""
    try:
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError):
        rss = 0
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime, rss


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(workload: str) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, its workload entry, the configuration, the
    traffic), all found by name."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}")
    config = load_json(os.path.join(HERE, "configs",
                                    f"{entry['config']}.json"))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     f"{entry['traffic']}.json"))
    return bench, entry, config, traffic


def refuse_unjudged(flags: dict) -> None:
    """Stop where the configuration's ``run`` sets a flag that changes the
    compared outputs but that the reference does not model: a run under
    it could only be misjudged."""
    for key, value in flags.items():
        if key == "maximum" and not value:
            continue
        if key not in JUDGED_FLAGS:
            raise SystemExit(
                f"the configuration's run sets {key}={value!r}, which the "
                "reference (benchmark/reference/humid_np.py) does not model")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


# ---------------------------------------------------------------------------
# Set-up steps
# ---------------------------------------------------------------------------

class Inputs:
    """The cell's FastQ files for a seed: found in the cache, or made by
    the generator in a child process started at once, so that it runs
    while the parent imports and builds."""

    def __init__(self, config: dict, traffic: dict, seed: int, name: str):
        key = hashlib.sha256(json.dumps([config["layout"], traffic],
                                        sort_keys=True).encode()).hexdigest()
        self.dir = os.path.join(CACHE, "data", name, f"{key[:12]}-{seed}")
        self.meta_path = os.path.join(self.dir, "meta.json")
        self.t0 = time.perf_counter()
        self.proc = None
        self.hit = os.path.exists(self.meta_path)
        if self.hit:
            return
        shutil.rmtree(self.dir, ignore_errors=True)
        self.tmp = f"{self.dir}.part"
        shutil.rmtree(self.tmp, ignore_errors=True)
        os.makedirs(self.tmp)
        cfg_path = os.path.join(self.tmp, "config.json")
        trf_path = os.path.join(self.tmp, "traffic.json")
        with open(cfg_path, "w") as f:
            json.dump(config, f)
        with open(trf_path, "w") as f:
            json.dump(traffic, f)
        self.proc = subprocess.Popen(
            [sys.executable, GENERATOR, cfg_path, trf_path, str(seed),
             self.tmp], stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    def wait(self) -> dict:
        if self.proc is not None:
            out, err = self.proc.communicate()
            if self.proc.returncode != 0:
                raise RuntimeError(f"generator failed:\n{err.decode()}")
            meta = json.loads(out.decode().strip().splitlines()[-1])
            meta["files"] = [os.path.join(self.dir, os.path.basename(p))
                             for p in meta["files"]]
            with open(os.path.join(self.tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            os.replace(self.tmp, self.dir)
            self.proc = None
            self.evict()
        else:
            meta = load_json(self.meta_path)
            meta["write_bytes"] = meta["wchar"] = 0
        meta["seconds"] = time.perf_counter() - self.t0
        meta["cache_hit"] = self.hit
        return meta

    def evict(self, keep: int = KEEP_SAMPLES) -> None:
        """Keep the cell's ``keep`` newest samples on disk: seeds seldom
        repeat, and a sample takes up to some hundreds of MB."""
        parent = os.path.dirname(self.dir)
        done = [os.path.join(parent, d) for d in os.listdir(parent)
                if os.path.exists(os.path.join(parent, d, "meta.json"))]
        done.sort(key=os.path.getmtime, reverse=True)
        for old in done[keep:]:
            if old != self.dir:
                shutil.rmtree(old, ignore_errors=True)

    def kill(self) -> None:
        if self.proc is not None:
            self.proc.kill()
            self.proc.wait()
            self.proc = None


OPENMP_PROBE = ("#include <omp.h>\n"
                "int main() { return omp_get_max_threads() > 0 ? 0 : 1; }\n")


def openmp_toolchain(work: str) -> dict:
    """The first C/C++ compiler pair that links ``-fopenmp`` (the
    extensions' recipe asks for it): $CC/$CXX, the path's gcc/g++, then
    /usr/bin's; empty where none does (setup.py's own choice then
    stands, and its build fails)."""
    src = os.path.join(work, "omp.cpp")
    with open(src, "w") as f:
        f.write(OPENMP_PROBE)
    pairs = [(os.environ.get("CC"), os.environ.get("CXX")),
             (shutil.which("gcc"), shutil.which("g++")),
             ("/usr/bin/gcc", "/usr/bin/g++")]
    for cc, cxx in pairs:
        if not cc or not cxx or not os.path.exists(cxx):
            continue
        proc = subprocess.run([cxx, "-fopenmp", src, "-o",
                               os.path.join(work, "omp")],
                              capture_output=True)
        if proc.returncode == 0:
            return {"CC": cc, "CXX": cxx}
    return {}


def build_extensions() -> dict:
    """``python setup.py build_ext --inplace`` in the checkout, by the
    first compiler pair that links OpenMP (a no-op when the extensions
    are up to date).  Returns the pair, the exit code and the output."""
    with tempfile.TemporaryDirectory(prefix="portbench-cc-") as work:
        pair = openmp_toolchain(work)
    proc = subprocess.run(
        [sys.executable, "setup.py", "build_ext", "--inplace"], cwd=ROOT,
        env={**os.environ, **pair}, capture_output=True, text=True)
    return {"toolchain": pair, "rc": proc.returncode,
            "output": proc.stdout + proc.stderr}


ROUTE_CHILD = """
import json, os, sys, torch
from humid_tpu_torch import pipeline
files, flags, out = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
res = pipeline.run(files, log_name=os.devnull, dir_name=out,
                   device=torch.device(sys.argv[4]), **flags)
print(json.dumps(res.extra.get("engine", {}), default=str))
"""


def calibration_off() -> bool:
    return os.environ.get("HUMID_TPU_TORCH_CALIBRATION", "").lower() in (
        "off", "0", "no")


def route_in_child(files, flags, work: str, device: str) -> dict | None:
    """Where the router's calibration is on: one ``run`` on the cell's
    files in a child process, so that every choice the router makes at
    this size, and any measurement or refresh of its calibration that a
    choice sets off, happens outside the measured process (measured in
    it, the calibration left the whole window slower).  Returns the
    child's route, its seconds and whether the calibration file changed;
    None where the calibration is off."""
    if calibration_off():
        return None
    path = os.environ["HUMID_TPU_TORCH_CALIB_PATH"]

    def stamp():
        try:
            with open(path, "rb") as f:
                return hashlib.sha256(f.read()).hexdigest()
        except OSError:
            return None

    before, t = stamp(), time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", ROUTE_CHILD, json.dumps(files),
         json.dumps(flags), os.path.join(work, "route"), device],
        cwd=ROOT, check=True, capture_output=True, text=True).stdout
    return {"route": json.loads(out.strip().splitlines()[-1]),
            "seconds": time.perf_counter() - t,
            "calibration_changed": stamp() != before}


def require_extensions() -> dict:
    """Import each host extension of the port; stop if any fails."""
    found = {}
    for mod in EXTENSIONS:
        try:
            importlib.import_module(mod)
            found[mod] = True
        except ImportError as exc:
            found[mod] = False
            log(f"extension {mod} does not import: {exc}")
    log("host extensions:", json.dumps(found))
    if not all(found.values()):
        raise SystemExit("a host extension of the port did not import; "
                         "the benchmark measures the port as built")
    return found


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def set_cache_env() -> None:
    """Every cache of the program inside the checkout, at fixed paths."""
    os.environ["HUMID_TPU_TORCH_CALIB_PATH"] = os.path.join(
        CACHE, "engine_calib.json")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(CACHE, "nv"))
    os.environ.setdefault("USE_FLAX", "0")


def stated_route(env: dict, route: dict) -> bool:
    """Did the run take the neighbour engine and the unique engine that
    the cell's ``environment`` states (where it states them)?"""
    want = {"strategy": env.get("HUMID_TPU_TORCH_STRATEGY"),
            "unique": env.get("HUMID_TPU_TORCH_UNIQUE")}
    return all(route.get(k) == v for k, v in want.items() if v)


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------

def _array_diff(got, want) -> int:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return int(max(got.size, want.size))
    return int((got != want).sum())


def compare(ref, stat_dirs: list, samples: list) -> tuple[dict, set]:
    """The numbers compared, each {"value", "limit"}, and the iterations
    found wrong.  ``stat_dirs`` [(iteration, directory)] hold each
    iteration's statistics files; ``samples`` [(iteration, counts, degree,
    rep_reads)] the whole results kept."""
    wrong: set = set()
    files_differing = 0
    for it, d in stat_dirs:
        for name in STAT_FILES:
            path = os.path.join(d, name)
            got = open(path, "rb").read() if os.path.exists(path) else None
            if got != ref.files[name]:
                files_differing += 1
                wrong.add(it)
    counts = degrees = reps = 0
    for it, c, g, r in samples:
        dc = _array_diff(c, ref.counts)
        dg = _array_diff(g, ref.degree)
        r = np.asarray(r)
        dr = int(len(np.setxor1d(r, ref.rep_reads))) + int(
            len(r) != len(np.unique(r)))
        counts, degrees, reps = counts + dc, degrees + dg, reps + dr
        if dc or dg or dr:
            wrong.add(it)
    checks = {"stats_files_differing": files_differing,
              "unique_counts_differing": counts,
              "neighbour_degrees_differing": degrees,
              "rep_reads_differing": reps}
    return {k: {"value": v, "limit": 0} for k, v in checks.items()}, wrong


# ---------------------------------------------------------------------------
# Per-layer metrics
# ---------------------------------------------------------------------------

class Context:
    """What a per-layer metric's reader may read: each window iteration's
    phase timers (seconds, by the program's phase names), the profiled
    slice's trace summary (``trace``; empty when nothing was traced), the
    reference's unique words and pairs, the word's lanes, the
    configuration's ``run`` flags (``flags``) and the reference's whole
    ``Result`` (``ref``; None where there is none)."""

    def __init__(self, timings, trace, unique, pairs, lanes, flags=None,
                 ref=None):
        self.timings = timings
        self.trace = trace
        self.unique = unique
        self.pairs = pairs
        self.lanes = lanes
        self.flags = flags or {}
        self.ref = ref

    def phase_ms(self, names) -> float | None:
        """Mean over the window's iterations of the named phases' sum, in
        ms; None where no iteration has any of them."""
        vals = [sum(t[n] for n in names if n in t) for t in self.timings
                if any(n in t for n in names)]
        return 1e3 * float(np.mean(vals)) if vals else None


def read_metric(name: str, ctx: Context):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, *, on_card: bool = True, build: bool = True,
         traffic_override: dict | None = None) -> int:
    """One run; returns the exit code.  ``on_card=False`` skips the look
    for a card and runs the program on the CPU, ``build=False`` takes the
    host extensions as they are, and ``traffic_override`` replaces traffic
    parameters: the CPU tests' levers, never the benchmark's."""
    t_start = time.perf_counter()
    args = parse(argv)
    bench, entry, config, traffic = cell(args.workload)
    refuse_unjudged(config["run"])
    if traffic_override:
        traffic = {**traffic, **traffic_override}
    io0 = proc_io()
    set_cache_env()
    # The program settings the configuration and the traffic state (the
    # cell's route), before any library that reads them is loaded.
    stated = {k: str(v) for k, v in {**config.get("environment", {}),
                                     **traffic.get("environment", {})}.items()}
    os.environ.update(stated)
    setup = {}
    inputs = Inputs(config, traffic, args.seed, args.workload)
    pool = ThreadPoolExecutor(max_workers=1)
    build_job = pool.submit(build_extensions) if build else None
    try:
        t = time.perf_counter()
        import torch
        setup["torch_import_s"] = time.perf_counter() - t
        if on_card and (not torch.cuda.is_available() or
                        torch.cuda.device_count() < int(entry["chips"])):
            log(f"no CUDA device, or fewer than {entry['chips']}: "
                "nothing measured")
            return 2
        t = time.perf_counter()
        if build_job is not None:
            built = build_job.result()
            log("extension build:", json.dumps(built["toolchain"]),
                "rc", built["rc"])
            if built["rc"] != 0:
                log(built["output"][-4000:])
                log("python setup.py build_ext --inplace failed")
                return 1
            require_extensions()
        setup["extensions_s"] = time.perf_counter() - t
        t = time.perf_counter()
        from humid_tpu_torch import pipeline as program
        setup["program_import_s"] = time.perf_counter() - t
        log("card:", card_line() if on_card else "none (CPU run)")
        log(f"host: cores {len(os.sched_getaffinity(0))} "
            f"torch_threads {torch.get_num_threads()} "
            f"OMP_NUM_THREADS {os.environ.get('OMP_NUM_THREADS')}")
        env = {k: v for k, v in os.environ.items()
               if k.startswith("HUMID_TPU_TORCH_")}
        log("program environment:", json.dumps(env))
        meta = inputs.wait()
        setup["data_s"] = meta["seconds"]
        log("data:", json.dumps({k: meta[k] for k in (
            "reads", "cache_hit", "seconds", "generator_s", "write_bytes",
            "wchar") if k in meta}))
        flags = dict(config["run"])
        files = meta["files"]
        with tempfile.TemporaryDirectory(prefix="portbench-") as work:
            # On a quiet host (the build and the generator have ended),
            # and before this process holds the card.
            child = route_in_child(files, flags, work,
                                   "cuda:0" if on_card else "cpu")
            log("router's choices in a child process:",
                json.dumps(child) if child else
                "none (the calibration is off; the route is stated)")
            setup["route_child_s"] = child and child["seconds"]
            if on_card:
                t = time.perf_counter()
                torch.cuda.init()
                torch.zeros(1, device="cuda").sum().item()
                setup["cuda_init_s"] = time.perf_counter() - t
                device = torch.device("cuda", 0)
            else:
                device = torch.device("cpu")
            t = time.perf_counter()
            warm = program.run(files, log_name=os.devnull,
                               dir_name=os.path.join(work, "warm"),
                               device=device, **flags)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            setup["warmup_s"] = time.perf_counter() - t
            log("route:", json.dumps(warm.extra.get("engine", {}),
                                     default=str),
                "as stated" if stated_route(stated, warm.extra.get(
                    "engine", {})) else "NOT as stated", json.dumps(stated))
            del warm
            gc.collect()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            setup_s = process_age_s()
            if setup_s is None:
                setup_s = time.perf_counter() - t_start
            setup["setup_s"] = setup_s
            log("set-up:", json.dumps(setup))

            result = window(program, files, flags, device, work, args,
                            torch)
            # The window has closed.
            mem_peak = (torch.cuda.max_memory_allocated(device)
                        if device.type == "cuda" else 0)
            rss_peak = vm_hwm_bytes()
            trace = {}
            if args.trace:
                trace = profiled_slice(program, files, flags, device, work,
                                       torch, result)
            t = time.perf_counter()
            from reference import humid_np
            ref = humid_np.humid(files, flags["word_length"],
                                 flags["distance"],
                                 edit=flags.get("edit", False))
            ref_s = time.perf_counter() - t
            checks, wrong = compare(ref, result["stat_dirs"],
                                    result["samples"])
    finally:
        inputs.kill()
        pool.shutdown(wait=True)

    raised = result["raised"]
    failed = len(wrong | set(raised))
    checks["iterations_failed"] = {"value": failed, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    kernels = trace.get("kernels_per_iteration", [])
    if kernels:
        log("kernels per profiled iteration:", kernels,
            "(equal)" if len(set(kernels)) == 1 else "(NOT equal)")
    routes = {json.dumps(r, sort_keys=True, default=str)
              for r in result["routes"]}
    log(f"window: {result['iterations']} iterations in "
        f"{result['window_s']:.4f} s; distinct routes {len(routes)}")
    log("window quarters (iterations, mean s, and each phase's mean ms):",
        json.dumps(quarters(result)))
    log(f"reference: {ref_s:.2f} s, {len(ref.keys)} unique words, "
        f"{int(ref.degree.sum()) // 2} pairs, {len(ref.sizes)} clusters, "
        f"{ref.candidates} candidates")
    io1 = proc_io()
    log("bytes written by the run and its children (write_bytes, wchar):",
        json.dumps({k: io1.get(k, 0) - io0.get(k, 0)
                    for k in ("write_bytes", "wchar")}))

    metrics = {}
    if not args.trace:
        values = {
            "reads_per_s": (sum(result["reads"]) / result["window_s"]),
            "device_peak_mib": mem_peak / 2 ** 20,
            "host_peak_rss_mib": rss_peak / 2 ** 20,
            "setup_s": setup_s,
        }
        for m in bench["end_to_end"]:
            if applies(m, args.workload):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        ctx = Context(result["timings"], trace, unique=len(ref.keys),
                      pairs=int(ref.degree.sum()) // 2,
                      lanes=-(-flags["word_length"] // 16), flags=flags,
                      ref=ref)
        for m in bench["per_layer"]:
            if applies(m, args.workload):
                v = read_metric(m["name"], ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(mem_peak)}
    line = {"correct": correct, "attempted": result["iterations"],
            "failed": failed, "metrics": metrics, "device": device_info}
    if args.trace and trace:
        device_info["busy_s"] = trace["busy_s"]
        device_info["window_s"] = trace["window_s"]
        line["breakdown"] = {"device_ops": trace["device_ops"],
                             "idle_gaps": trace["idle_gaps"]}
    line["checks"] = checks
    bad = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if bad:
        log("modules that may not be loaded in a run:", ", ".join(bad))
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def quarters(result: dict) -> list:
    """Each quarter of the window's iterations: their number, mean
    seconds, each phase's mean ms (a drift within a run shows here), the
    cores this process kept busy, and its resident MiB at the quarter's
    end."""
    its, tim, host = result["iter_s"], result["timings"], result["host"]
    n = len(its)
    out = []
    for q in range(4):
        lo, hi = n * q // 4, n * (q + 1) // 4
        if hi <= lo:
            continue
        part = tim[lo:hi] if len(tim) == n else []
        phases = {k: round(1e3 * float(np.mean([t.get(k, 0.0) for t in part])),
                           2) for k in (part[0] if part else {})}
        row = {"iterations": hi - lo,
               "mean_s": round(float(np.mean(its[lo:hi])), 5),
               "phases_ms": phases}
        if len(host) == n + 1:
            wall = float(np.sum(its[lo:hi]))
            row["cores_busy"] = round((host[hi][0] - host[lo][0])
                                      / max(wall, 1e-9), 3)
            row["rss_mib"] = round(host[hi][1] / 2 ** 20)
        out.append(row)
    return out


def window(program, files, flags, device, work, args, torch) -> dict:
    """``run`` back to back for ``args.seconds``; each iteration writes its
    statistics into a directory of its own."""
    rng = np.random.default_rng(args.seed)
    out = {"stat_dirs": [], "samples": [], "raised": [], "reads": [],
           "timings": [], "routes": [], "iter_s": [],
           "host": [host_sample()]}
    t0 = time.perf_counter()
    k = 0
    while True:
        d = os.path.join(work, f"it{k}")
        ti = time.perf_counter()
        try:
            res = program.run(files, log_name=os.devnull, dir_name=d,
                              device=device, **flags)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        except Exception as exc:  # an iteration that raises is counted
            log(f"iteration {k} raised: {exc!r}")
            out["raised"].append(k)
            res = None
        now = time.perf_counter()
        out["iter_s"].append(now - ti)
        out["host"].append(host_sample())
        if res is not None:
            out["reads"].append(int(res.total))
            out["timings"].append(dict(res.extra.get("timings", {})))
            out["routes"].append(res.extra.get("engine", {}))
            out["stat_dirs"].append((k, d))
            kept = (k, res.counts, res.degree, res.rep_reads)
            if len(out["samples"]) < SAMPLED:
                out["samples"].append(kept)
            else:
                j = int(rng.integers(0, k + 1))
                if j < SAMPLED:
                    out["samples"][j] = kept
            del res
        k += 1
        if now - t0 >= args.seconds:
            break
    out["window_s"] = now - t0
    out["iterations"] = k
    return out


def profiled_slice(program, files, flags, device, work, torch, result):
    """``PROFILED`` more iterations under ``torch.profiler``, each in a
    range of its own; their statistics files join the comparison."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace as T

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        for k in range(PROFILED):
            it = result["iterations"] + k
            d = os.path.join(work, f"it{it}")
            with record_function(f"{T.ITERATION_PREFIX}{k}"):
                program.run(files, log_name=os.devnull, dir_name=d,
                            device=device, **flags)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            result["stat_dirs"].append((it, d))
    path = os.path.join(work, "trace.json")
    prof.export_chrome_trace(path)
    summary = T.summarize(T.load_events(path))
    os.remove(path)
    return summary
