"""Engine layer (serving/engine.py), throughput cells: the StepRecord
prefill walls of the window's steps over the window, in %; moves
decode_tok_s."""
from fdbench.lib import readers

read = readers.prefill_share_pct
