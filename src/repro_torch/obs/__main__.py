"""``python -m repro_torch.obs`` -- run-log toolchain entry point."""

import sys

from repro_torch.obs.reader import main

try:
    sys.exit(main())
except BrokenPipeError:  # `... | head` closing the pipe is not an error
    sys.exit(0)
