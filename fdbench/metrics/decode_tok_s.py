"""End to end, closed loops: output tokens emitted in the window over the
window's seconds."""
from fdbench.lib import readers

read = readers.decode_tok_s
