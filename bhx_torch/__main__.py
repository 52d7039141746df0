"""``python -m bhx_torch``: the command line (:mod:`bhx_torch.cli`)."""

import sys

from bhx_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
