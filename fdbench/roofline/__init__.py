"""Operation and byte counts of the kernels and of the model step, one
file each, computed from shapes and the real lengths."""
