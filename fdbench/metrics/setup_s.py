"""End to end: process start to window start (imports, kernel build,
weights, engine, graph capture, the fill or pre-roll, warm-up)."""
from fdbench.lib import readers

read = readers.setup_s
