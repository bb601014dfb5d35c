"""Command-line interface, drop-in compatible with the reference binary.

Flag surface and defaults from humid.cc:413-429 (commandIO interface):

  -n 24   word length           -q      (toggle) write dedup FastQ [on]
  -m 1    allowed mismatches    -a      write annotated FastQ
  -l /dev/stderr  log file      -e      use edit distance
  -d .    output directory      -x      use maximum clustering method
  -s      calculate statistics  files   FastQ files (positional)

commandIO boolean flags TOGGLE their default, so ``-q`` turns the dedup
output OFF — replicated here with store_false.

The neighbour search runs on the torch device named by
HUMID_TPU_TORCH_DEVICE (default ``cuda``).

Several processes (``--coordinator HOST:PORT --num-processes N
--process-id I``, one command per process, on one machine or several)
run :func:`humid_tpu_torch.parallel.run_distributed` over a ``gloo``
process group whose rendezvous process 0 serves at HOST:PORT; with a
bare ``cuda`` device process I takes card I % cards.
"""

from __future__ import annotations

import argparse
import sys
import zlib

from .errors import DeviceUnavailableError, InputError
from .pipeline import run

# Input errors (missing file, empty/corrupt/truncated FastQ or gzip) and
# an unusable device get a clean CLI diagnostic instead of a traceback.
# Internal errors (including generic ValueError) keep their tracebacks.
_USER_ERRORS = (OSError, EOFError, zlib.error, InputError,
                DeviceUnavailableError)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="humid-tpu-torch", description="Deduplicate a dataset."
    )
    p.add_argument("-n", type=int, default=24, metavar="WORDLENGTH",
                   help="word length (default 24)")
    p.add_argument("-m", type=int, default=1, metavar="MISMATCHES",
                   help="allowed mismatches (default 1)")
    p.add_argument("-l", type=str, default="/dev/stderr", metavar="LOG",
                   help="log file name")
    p.add_argument("-d", type=str, default=".", metavar="DIR",
                   help="output directory")
    p.add_argument("-s", action="store_true",
                   help="calculate statistics")
    p.add_argument("-q", action="store_false", dest="q",
                   help="toggle writing deduplicated FastQ files (default on)")
    p.add_argument("-a", action="store_true",
                   help="write annotated FastQ files")
    p.add_argument("-e", action="store_true",
                   help="use edit distance")
    p.add_argument("-x", action="store_true",
                   help="use maximum clustering method")
    p.add_argument("--coordinator", type=str, default=None,
                   metavar="HOST:PORT",
                   help="rendezvous of a multi-process run (process 0 "
                        "serves it; extension over the reference)")
    p.add_argument("--num-processes", type=int, default=None,
                   metavar="N", help="number of processes in the run")
    p.add_argument("--process-id", type=int, default=None,
                   metavar="I", help="this process's index")
    p.add_argument("files", nargs="+", help="FastQ files")
    return p


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.coordinator is not None or (args.num_processes or 0) > 1:
        return _main_distributed(parser, args)
    try:
        run(
            args.files,
            word_length=args.n,
            distance=args.m,
            log_name=args.l,
            dir_name=args.d,
            run_stats=args.s,
            write_dedup=args.q,
            write_annotated=args.a,
            maximum=args.x,
            edit=args.e,
        )
    except _USER_ERRORS as exc:
        print(f"humid-tpu-torch: error: {exc}", file=sys.stderr)
        return 1
    return 0


def _main_distributed(parser, args) -> int:
    from .parallel import multihost
    from .parallel.pipeline import run_distributed

    if args.coordinator is None:
        # Without a coordinator the processes cannot exchange tables;
        # each would cluster its own range alone.
        parser.error("--num-processes > 1 requires --coordinator")
    try:
        multihost.init_distributed(args.coordinator, args.num_processes,
                                   args.process_id)
    except ValueError as exc:
        parser.error(str(exc))
    try:
        run_distributed(
            args.files,
            word_length=args.n,
            distance=args.m,
            log_name=args.l,
            dir_name=args.d,
            run_stats=args.s,
            write_dedup=args.q,
            write_annotated=args.a,
            maximum=args.x,
            edit=args.e,
            process_id=args.process_id,
            num_processes=args.num_processes,
        )
    except _USER_ERRORS as exc:
        print(f"humid-tpu-torch: error: {exc}", file=sys.stderr)
        return 1
    finally:
        multihost.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
