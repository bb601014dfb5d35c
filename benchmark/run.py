"""The benchmark of ``humid_tpu_torch``: one run of one cell.

    python benchmark/run.py --workload <config>.<traffic> --seed N \\
                            --seconds S --trace 0|1

Prints set-up, route, card and checks on standard error and, as the last
line of standard output, one JSON object (see ``pbench/harness.py``).
"""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
# The program under test is imported from the checkout's root.
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from pbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:]))
