"""Build the native extensions:

    python setup.py build_ext --inplace

* humid_tpu.cluster._ccluster — CSR clustering with the reference's exact
  traversal semantics (csrc/cluster.cpp).
* humid_tpu.io._cfastqio — bulk FastQ record framing (csrc/fastqio.cpp).
* humid_tpu._hostops — host sort/unique/run helpers (csrc/hostops.cpp).

The PyTorch port (humid_tpu_torch) builds the same three sources under
its own package path, and one more of its own:

* humid_tpu_torch.io._cumi — pass 1's UMI parse straight from the header
  spans (csrc/umi_parse.cpp).  A source of its own, not a function of
  csrc/fastqio.cpp, because that file also builds the JAX package's
  extension and the parse exists for the port alone.
* humid_tpu_torch._cedit — the -e search's merge joins and the union of
  their pairs by the first join that finds each (csrc/edit_union.cpp),
  kept out of csrc/hostops.cpp for the same reason.

Its CUDA kernels are not built here: they are compiled with nvcc at
first use (humid_tpu_torch/_build.py).

All are optional: the pure-Python/numpy fallbacks produce identical
results.
"""

import os

from setuptools import Extension, setup

_HAVE_DEFLATE = os.path.exists("/usr/include/libdeflate.h")

setup(
    name="humid_tpu",
    version="0.1.0",
    packages=[
        "humid_tpu",
        "humid_tpu.cluster",
        "humid_tpu.io",
        "humid_tpu.ops",
        "humid_tpu.parallel",
        "humid_tpu_torch",
        "humid_tpu_torch.cluster",
        "humid_tpu_torch.io",
        "humid_tpu_torch.ops",
        "humid_tpu_torch.parallel",
        "humid_tpu_torch.tools",
    ],
    package_data={"humid_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    entry_points={
        "console_scripts": ["humid-tpu = humid_tpu.cli:main",
                            "humid-tpu-torch = humid_tpu_torch.cli:main"],
    },
    ext_modules=[
        ext
        for pkg in ("humid_tpu", "humid_tpu_torch")
        for ext in (
            Extension(
                f"{pkg}.cluster._ccluster",
                sources=["csrc/cluster.cpp"],
                extra_compile_args=["-O3", "-std=c++17", "-fopenmp"],
                extra_link_args=["-fopenmp"],
            ),
            Extension(
                f"{pkg}.io._cfastqio",
                sources=["csrc/fastqio.cpp"],
                extra_compile_args=(
                    ["-O3", "-std=c++17"]
                    + (["-DHAVE_LIBDEFLATE"] if _HAVE_DEFLATE else [])
                ),
                libraries=["deflate"] if _HAVE_DEFLATE else [],
            ),
            Extension(
                f"{pkg}._hostops",
                sources=["csrc/hostops.cpp"],
                extra_compile_args=["-O3", "-std=c++17", "-fopenmp"],
                extra_link_args=["-fopenmp"],
            ),
        )
    ] + [
        Extension(
            "humid_tpu_torch.io._cumi",
            sources=["csrc/umi_parse.cpp"],
            extra_compile_args=["-O3", "-std=c++17"],
        ),
        Extension(
            "humid_tpu_torch._cedit",
            sources=["csrc/edit_union.cpp"],
            extra_compile_args=["-O3", "-std=c++17", "-fopenmp"],
            extra_link_args=["-fopenmp"],
        ),
    ],
)
