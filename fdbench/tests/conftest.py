"""The benchmark's own tests: run from the repository's root with
``python -m pytest fdbench/tests -q`` (the card's with ``-m cuda``)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
