import sys

from runet_tpu_torch.cli import main

# Propagate command return codes (doctor / serve --once report failure as
# nonzero); commands returning None exit 0. Guarded so that importing the
# module (as the tests import every module) runs nothing.
if __name__ == "__main__":
    sys.exit(main())
