"""``python -m nomad_tpu_torch.cli``: the CLI entry point."""

import sys

from .main import main

if __name__ == "__main__":
    sys.exit(main())
