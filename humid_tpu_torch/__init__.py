"""humid_tpu_torch — reference-free FastQ deduplication on PyTorch/CUDA.

The PyTorch port of :mod:`humid_tpu` (the JAX/TPU package, kept beside it
as the reference): 2-bit packed integer fingerprints, a hand-written CUDA
Hamming tile sweep for Hopper GPUs (``csrc/hamming_sweep.cu``), banded
Levenshtein programs for edit distance (``ops/edit.py``), and the
reference's exact clustering.  It imports torch and never jax.  The
device is ``device=`` or HUMID_TPU_TORCH_DEVICE (default ``cuda``); see
``_device.py``.
"""

from ._util import tune_malloc  # noqa: F401
from .pipeline import run, PipelineResult

__version__ = "0.1.0"

__all__ = ["run", "PipelineResult", "__version__"]
