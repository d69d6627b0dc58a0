"""``python -m salamander_tpu``: the command-line entry point (cli.main)."""

import sys

from .cli import main
from .device import enable_compile_cache

if __name__ == "__main__":
    enable_compile_cache()
    sys.exit(main())
