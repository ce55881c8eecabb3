"""Kernels (kernel 1, paged_attn_kernel + merge_splits), throughput cells:
its roofline's least time over its device time in the profiled slice, in
%; moves decode_tok_s."""
from fdbench.lib import readers

read = readers.attn_roofline
