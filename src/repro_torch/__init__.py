"""PyTorch/CUDA port of the FastDecode reproduction.

A package of its own beside the JAX reference ``repro``: it imports
``torch`` and ``numpy`` and never ``jax`` or anything of ``repro``.  Its
paths mirror the reference's (``repro/X/y.py`` -> ``repro_torch/X/y.py``)
and its entry points take ``device=`` (default ``"cuda"``).
"""
