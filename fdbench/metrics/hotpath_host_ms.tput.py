"""Pipeline layer (core/hetero.py, core/graphs.py), throughput cells: host
ms a decode step in S-dispatch, dispatch and collect (hotpath_stats over
the window); moves decode_tok_s."""
from fdbench.lib import readers

read = readers.hotpath_host_ms
