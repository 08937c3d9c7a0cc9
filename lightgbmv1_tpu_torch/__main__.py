"""``python -m lightgbmv1_tpu_torch config=train.conf [key=value ...]``:
the CLI (cli.py; reference src/main.cpp:11-42)."""

import sys

from .cli import main

sys.exit(main())
