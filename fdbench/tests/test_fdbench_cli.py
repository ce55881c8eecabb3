"""The command as the driver runs it: without the card the cell asks
for, and in a directory that holds only BENCHMARK.json and the
benchmark's own files, it exits nonzero and prints no result."""
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

FDBENCH = Path(__file__).resolve().parents[1]
ROOT = FDBENCH.parent
ARGS = ["--workload", "opt-175b.s8.batch", "--seed", str(2 ** 33 + 5),
        "--seconds", "1", "--trace", "0"]


def _run(cwd: Path):
    return subprocess.run([sys.executable, "fdbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin",
                                            "BENCH_RUN": "x"})


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(FDBENCH, tmp_path / "fdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
