"""``python -m tpu_syncbn_torch.launch`` — one process per GPU; the port's
``python -m torch.distributed.launch`` (see
:mod:`tpu_syncbn_torch.runtime.launcher`)."""

import sys

from tpu_syncbn_torch.runtime.launcher import main

if __name__ == "__main__":
    sys.exit(main())
