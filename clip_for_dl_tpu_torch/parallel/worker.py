"""One rank of a group that runs a function:
``python -m clip_for_dl_tpu_torch.parallel.worker MODULE:FUNCTION WORKDIR
[--device cpu|cuda] [--timeout SECONDS]``, started by ``torchrun``.

The rank joins the group (:func:`multihost.init_process_group`, from the
variables ``torchrun`` sets, a collective waiting at most ``--timeout``
seconds), runs on one thread, calls ``FUNCTION(WORKDIR)`` and leaves the
group. The function is imported by module name, as a child process must
import it; the CPU tests keep theirs in ``clip_for_dl_tpu_torch.testing.ranks``
and exchange inputs and results through files in ``WORKDIR``.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import sys

import torch

from . import multihost


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("target", help="MODULE:FUNCTION")
    ap.add_argument("workdir")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--timeout", type=float,
                    default=multihost.DEFAULT_TIMEOUT.total_seconds(),
                    help="seconds a collective may wait for the other ranks")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    module, _, name = args.target.partition(":")
    fn = getattr(importlib.import_module(module), name)
    multihost.init_process_group(device=args.device,
                                 timeout=datetime.timedelta(seconds=args.timeout))
    try:
        fn(args.workdir)
    finally:
        multihost.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
