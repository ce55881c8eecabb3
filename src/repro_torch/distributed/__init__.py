"""Logical-axis sharding on ``DeviceMesh`` / DTensor (the JAX package's
``repro.distributed``): rules, the per-leaf layouts, the explicit
flash-decode schedule and the distributed MoE FFN."""
