"""The port's launchers as subprocesses (``python -m
repro_torch.launch.train`` / ``.serve``) on ``--device cpu`` at the
arguments of ``tests/test_launchers.py``: the same printed lines as the
JAX package's launchers.  Without ``--device`` they ask for the card and,
on a host with no CUDA, raise instead of falling back to the CPU."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.config import get_arch
from repro_torch.models import model as TM
from repro_torch.training import checkpoint as CK
from repro_torch.training.tree import leaves_with_path

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
TRAIN_ARGS = ["--arch", "qwen3-8b", "--reduced", "--layers", "2",
              "--d-model", "64", "--steps", "8", "--batch", "2",
              "--seq", "32", "--log-every", "4"]
SERVE_ARGS = ["--arch", "granite-3-8b", "--reduced", "--layers", "2",
              "--d-model", "64", "--backend", "hetero",
              "--admission", "loadctl", "--requests", "6", "--batch", "4",
              "--prompt-len", "4", "--max-new", "6", "--cache-len", "32",
              "--interval", "3"]


def _run(mod, args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["OMP_NUM_THREADS"] = "2"
    return subprocess.run([sys.executable, "-m", mod] + args,
                          capture_output=True, text=True, timeout=timeout,
                          env=env, cwd=ROOT)


def test_train_launcher(tmp_path):
    ck = str(tmp_path / "ck.npz")
    p = _run("repro_torch.launch.train",
             TRAIN_ARGS + ["--device", "cpu", "--save", ck])
    assert p.returncode == 0, p.stdout + p.stderr
    lines = p.stdout.splitlines()
    assert re.fullmatch(r"arch=qwen3-8b-smoke params=[\d.]+M devices=1",
                        lines[0]), lines[0]
    steps = [ln for ln in lines if ln.startswith("step")]
    # logged at 0, 4 and the last step, as the JAX package's launcher logs
    assert [int(ln.split()[1]) for ln in steps] == [0, 4, 7]
    losses = [float(ln.split()[3]) for ln in steps]
    assert all(np.isfinite(losses))
    assert lines[-1] == f"saved {ck}"
    # the saved params load into a template of the same config
    cfg = get_arch("qwen3-8b").reduced(layers=2, d_model=64)
    like = TM.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    got = CK.load(ck, like)
    assert [p for p, _ in leaves_with_path(got)] == \
        [p for p, _ in leaves_with_path(like)]


def test_train_launcher_remat_and_frontend():
    """--remat, and an arch with a frontend (zero features, as the JAX
    package's launcher passes them)."""
    p = _run("repro_torch.launch.train",
             ["--arch", "whisper-medium", "--reduced", "--layers", "2",
              "--d-model", "64", "--steps", "3", "--batch", "2", "--seq",
              "16", "--log-every", "1", "--remat", "--device", "cpu"])
    assert p.returncode == 0, p.stdout + p.stderr
    assert len([ln for ln in p.stdout.splitlines()
                if ln.startswith("step")]) == 3


def test_serve_launcher():
    p = _run("repro_torch.launch.serve", SERVE_ARGS + ["--device", "cpu"])
    assert p.returncode == 0, p.stdout + p.stderr
    assert "served 6 requests" in p.stdout
    assert "peak resident length" in p.stdout


@pytest.mark.parametrize("mod,args", [
    ("repro_torch.launch.train", TRAIN_ARGS),
    ("repro_torch.launch.serve", SERVE_ARGS)], ids=["train", "serve"])
def test_launcher_defaults_to_the_card(mod, args):
    """No --device: the card.  Without CUDA that raises, naming the CPU
    option; nothing runs on the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    p = _run(mod, args, timeout=120)
    assert p.returncode != 0
    assert "CUDA is not available" in p.stderr
    assert "step" not in p.stdout and "served" not in p.stdout


def test_train_launcher_refuses_a_model_mesh():
    """Without torchrun the world is 1 rank, which a model axis of 2 does
    not divide (the reference's ``make_host_mesh`` asserts the same)."""
    p = _run("repro_torch.launch.train",
             TRAIN_ARGS + ["--device", "cpu", "--mesh-model", "2"],
             timeout=120)
    assert p.returncode == 2
    assert "does not divide the world size 1" in p.stderr
