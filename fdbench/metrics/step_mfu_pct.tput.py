"""Model step (models/model.py, core/decompose.py), throughput cells: model
FLOPs of the window over the window and the bf16 peak, in %; moves
decode_tok_s."""
from fdbench.lib import readers

read = readers.step_mfu_pct
