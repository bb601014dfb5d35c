"""k1_roofline: kernel K1, the dense Hamming tile sweep
(``csrc/hamming_sweep.cu``), as a share of its roofline, in %.

The least time for the U(U-1)/2 pairs the dense sweep must decide (U: the
reference's unique words; ``pbench/roofline.py``, the least of three
forms at the H100's published peaks) over K1's device time an iteration
in the profiled slice.  None where K1 did not run."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pbench.roofline import dense_sweep_roofline_s  # noqa: E402

KERNEL = "hamming_sweep_kernel"


def read(ctx):
    if not ctx.trace or not ctx.trace.get("iterations"):
        return None
    k1_s = sum(s for name, s in ctx.trace["kernel_s"].items()
               if KERNEL in name) / ctx.trace["iterations"]
    if k1_s <= 0:
        return None
    return 100.0 * dense_sweep_roofline_s(ctx.unique, ctx.lanes,
                                          ctx.pairs) / k1_s
