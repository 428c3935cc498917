import sys

from pilosa_tpu_torch.cli.main import main

sys.exit(main())
