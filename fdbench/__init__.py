"""The benchmark of ``repro_torch`` (the PyTorch/CUDA port): run one cell
with ``python3 fdbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``."""
