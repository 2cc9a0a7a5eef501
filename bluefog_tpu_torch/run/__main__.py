"""``python -m bluefog_tpu_torch.run`` == ``bfrun`` for the port."""

import sys

from bluefog_tpu_torch.run.run import main

if __name__ == "__main__":
    sys.exit(main())
