"""The port's train launcher on a model-parallel mesh: two CPU processes
under ``torch.distributed.run`` (gloo), ``--mesh-model 2``, against the
same launcher's world of 1 (which it makes itself without ``torchrun``):
the three steps' losses agree."""
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
ARGS = ["-m", "repro_torch.launch.train", "--arch", "granite-3-8b",
        "--reduced", "--layers", "2", "--d-model", "64", "--steps", "3",
        "--batch", "2", "--seq", "16", "--log-every", "1", "--device",
        "cpu"]


def _run(prefix):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["OMP_NUM_THREADS"] = "1"
    p = subprocess.run([sys.executable] + prefix + ARGS, capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-5000:]
    return p.stdout.splitlines()


def _losses(lines):
    return [float(ln.split()[3]) for ln in lines if ln.startswith("step")]


def test_train_launcher_on_a_model_mesh():
    two = _run(["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2"])
    one = _run([])
    # only rank 0 prints: one header, one line a step
    assert sum(ln.startswith("arch=") for ln in two) == 1
    assert [ln for ln in two if ln.startswith("arch=")][0].endswith(
        "devices=2")
    assert [ln for ln in one if ln.startswith("arch=")][0].endswith(
        "devices=1")
    l2, l1 = _losses(two), _losses(one)
    assert len(l2) == len(l1) == 3
    assert np.isfinite(l2).all() and np.isfinite(l1).all()
    # step 0 is the forward on the same weights; steps 1 and 2 follow the
    # updates (the printed losses carry 4 decimals)
    assert abs(l2[0] - l1[0]) <= 1e-5 * abs(l1[0])
    for a, b in zip(l2[1:], l1[1:]):
        assert abs(a - b) <= 1e-4 * abs(b)
