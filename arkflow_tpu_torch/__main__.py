import sys

from arkflow_tpu_torch.runtime.cli import main

sys.exit(main())
