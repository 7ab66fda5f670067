"""``python -m repro_torch.obs run.jsonl`` — schema-validate event streams
(non-zero exit on any error)."""

import sys

from .schema import main

sys.exit(main(sys.argv[1:]))
