"""``python -m mercury_tpu_torch``: the port's entry point (see
:mod:`mercury_tpu_torch.cli`)."""

import sys

from mercury_tpu_torch.cli import main

sys.exit(main())
