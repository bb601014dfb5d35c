"""Build and load the port's CUDA kernels.

Each ``humid_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` at first
use into ``build/humid_tpu_torch/lib<name>.so`` beside the package (the
``build/`` directory is git-ignored), for Hopper only::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

and loaded with ``ctypes``.  The sources have a plain C interface (no
PyTorch headers), so a build takes seconds.  A library older than its
source or than any shared header (``csrc/*.cuh``) is rebuilt.  The
compiler's output (``-Xptxas -v``: registers,
shared memory, spills per kernel) is kept in ``lib<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "humid_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built on first use")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built."""
    return BUILD_DIR / f"lib{name}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is up to date;
    returns the library's path.  Raises RuntimeError with the compiler's
    output when nvcc fails."""
    src = CSRC / f"{name}.cu"
    out = library_path(name)
    newest = max(p.stat().st_mtime for p in (src, *CSRC.glob("*.cuh")))
    if out.exists() and out.stat().st_mtime >= newest:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build under a private name and rename: concurrent first uses never
    # load a half-written library.
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all(names) -> list[Path]:
    """Build several kernels at once, one nvcc process each."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        return list(ex.map(build, names))


def disassemble(name: str) -> str:
    """The machine code (SASS) of the built ``csrc/<name>.cu``, as
    ``cuobjdump -sass`` prints it."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(build(name))], check=True,
                          capture_output=True, text=True).stdout


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process."""
    return ctypes.CDLL(str(build(name)))
