"""The traffic generator: FastQ files of a sequencing sample, made from a
configuration (the read layout) and a traffic mix (the sample's size and
duplication), deterministically from a seed.

    python benchmark/pbench/generate.py CONFIG.json TRAFFIC.json SEED OUTDIR

writes ``OUTDIR/r1.fastq`` (and ``r2.fastq`` for paired layouts) and
prints one JSON line: the files, the reads, and the bytes this process
wrote (``/proc/self/io``).  It imports numpy only, so it runs as a child
process whose arrays never count in the measured process's memory.

The traffic's ``generator`` names a module ``benchmark/generators/<name>.py``,
found by name as the metrics' readers are.  It defines either
``molecules(rng, traffic)``, the molecule each read copies (an int64 array
of ``traffic["reads"]`` indices, in file order), or ``generate(config,
traffic, seed, out_dir)``, which writes the files itself (with the helpers
here) and returns what :func:`generate` returns.

With ``molecules``: a sample is a set of molecules (fragments), each a
random sequence of ``umi_length + files * read_length`` bases.  Reads copy
a molecule, and every base of a read (its UMI included) is then
substituted by another base with probability ``substitution_rate``.  Names
are ``@r<10 digits>``, with ``_<UMI>`` appended where the layout has a UMI,
so HUMID takes the UMI from the last ``_`` field; qualities are all ``F``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
CHUNK = 1 << 18
GENERATORS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "generators")


def random_codes(rng: np.random.Generator, n: int, length: int) -> np.ndarray:
    """[n, length] uint8 base codes 0-3, four bases from each random byte."""
    total = n * length
    raw = np.frombuffer(rng.bytes(-(-total // 4)), np.uint8)
    codes = np.empty((raw.size, 4), np.uint8)
    for k in range(4):
        codes[:, k] = (raw >> (2 * k)) & 3
    return codes.reshape(-1)[:total].reshape(n, length)


def generator(traffic: dict):
    """The module ``generators/<traffic["generator"]>.py``."""
    name = traffic["generator"]
    path = os.path.join(GENERATORS, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_generator_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sample_codes(config: dict, traffic: dict, seed: int,
                 molecules) -> np.ndarray:
    """[reads, umi_length + files * read_length] uint8 codes of every read
    (UMI first, then each file's read), errors applied; ``molecules(rng,
    traffic)`` picks each read's molecule."""
    layout = config["layout"]
    length = int(layout["umi_length"]) + int(layout["files"]) * int(
        layout["read_length"])
    rng = np.random.default_rng(seed)
    mol = molecules(rng, traffic)
    seen, inverse = np.unique(mol, return_inverse=True)
    reads = random_codes(rng, len(seen), length)[inverse]
    flat = reads.reshape(-1)
    n_err = int(rng.binomial(flat.size, float(traffic["substitution_rate"])))
    pos = np.unique(rng.integers(0, flat.size, n_err))
    flat[pos] = (flat[pos] + rng.integers(1, 4, len(pos)).astype(np.uint8)) & 3
    return reads


def _digits(ids: np.ndarray, width: int) -> np.ndarray:
    out = np.empty((len(ids), width), np.uint8)
    v = ids.copy()
    for p in range(width - 1, -1, -1):
        out[:, p] = (v % 10) + ord("0")
        v //= 10
    return out


def write_fastq(path: str, codes: np.ndarray, umi: np.ndarray | None) -> None:
    """FastQ records of ``codes`` ([n, read_length] base codes); names carry
    ``umi`` ([n, umi_length] codes) after an underscore when given."""
    n, read_len = codes.shape
    umi_len = 0 if umi is None else umi.shape[1]
    name_len = 1 + 1 + 10 + (1 + umi_len if umi_len else 0)
    rec_len = name_len + 1 + read_len + 3 + read_len + 1
    with open(path, "wb") as f:
        for lo in range(0, n, CHUNK):
            hi = min(lo + CHUNK, n)
            rec = np.full((hi - lo, rec_len), ord("F"), np.uint8)
            rec[:, 0] = ord("@")
            rec[:, 1] = ord("r")
            rec[:, 2:12] = _digits(np.arange(lo, hi, dtype=np.int64), 10)
            if umi_len:
                rec[:, 12] = ord("_")
                rec[:, 13:13 + umi_len] = BASES[umi[lo:hi]]
            s = name_len
            rec[:, s] = 10
            rec[:, s + 1:s + 1 + read_len] = BASES[codes[lo:hi]]
            s += 1 + read_len
            rec[:, s] = 10
            rec[:, s + 1] = ord("+")
            rec[:, s + 2] = 10
            rec[:, rec_len - 1] = 10
            f.write(rec.tobytes())


def generate(config: dict, traffic: dict, seed: int, out_dir: str) -> dict:
    """Write the sample's FastQ files into ``out_dir``; returns their paths
    and the number of reads (read pairs count once)."""
    mod = generator(traffic)
    if hasattr(mod, "generate"):
        return mod.generate(config, traffic, seed, out_dir)
    layout = config["layout"]
    umi_len, read_len = int(layout["umi_length"]), int(layout["read_length"])
    codes = sample_codes(config, traffic, seed, mod.molecules)
    umi = codes[:, :umi_len] if umi_len else None
    files = []
    for k in range(int(layout["files"])):
        path = os.path.join(out_dir, f"r{k + 1}.fastq")
        lo = umi_len + k * read_len
        write_fastq(path, codes[:, lo:lo + read_len], umi)
        files.append(path)
    return {"files": files, "reads": int(len(codes))}


def io_counters() -> dict:
    """This process's ``/proc/self/io`` (empty where it cannot be read)."""
    try:
        with open("/proc/self/io") as f:
            return {k: int(v) for k, v in
                    (line.split(":") for line in f if ":" in line)}
    except OSError:
        return {}


def main(argv: list[str]) -> int:
    t0 = time.perf_counter()
    config_path, traffic_path, seed, out_dir = argv
    with open(config_path) as f:
        config = json.load(f)
    with open(traffic_path) as f:
        traffic = json.load(f)
    out = generate(config, traffic, int(seed), out_dir)
    io = io_counters()
    out["write_bytes"] = io.get("write_bytes")
    out["wchar"] = io.get("wchar")
    out["generator_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
