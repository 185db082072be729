"""`python -m systemml_tpu_torch -f script.dml ...`: the CLI (api/cli.py)."""

import sys

from systemml_tpu_torch.api.cli import main

if __name__ == "__main__":
    sys.exit(main())
