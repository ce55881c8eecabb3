"""Device, throughput cells: 1 - the union of device intervals over the
profiled slice's wall, in %; moves decode_tok_s."""
from fdbench.lib import readers

read = readers.device_idle_pct
