"""Entry point: ``python -m repro_torch.analysis`` (see cli.py for the
contract)."""
import sys

from .cli import main

sys.exit(main())
