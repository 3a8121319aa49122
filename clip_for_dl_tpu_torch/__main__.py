"""``python -m clip_for_dl_tpu_torch <command>``: the port's command line (cli/main.py)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
