"""End-to-end training on the port: a ~100M-parameter
llama-family model on the synthetic LM stream for a few hundred steps
(use --quick on slow hosts).

    PYTHONPATH=src python -m repro_torch.examples.train_small            # ~100M, 300 steps
    PYTHONPATH=src python -m repro_torch.examples.train_small --quick    # ~10M, 60 steps
    PYTHONPATH=src python -m repro_torch.examples.train_small --quick --device cpu

The ~100M run saves its params to a file in the temp directory
(``tempfile``) unless ``--save`` names one; ``--quick`` saves only to a
``--save`` path.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch import train as T


def build_argv(quick: bool, steps: int = 0, save: str = "",
               device: str = "cuda") -> list:
    """The train launcher's argv for the two runs."""
    if quick:
        argv = ["--arch", "granite-3-8b", "--reduced", "--layers", "4",
                "--d-model", "256", "--steps", str(steps or 60),
                "--batch", "8", "--seq", "128", "--lr", "6e-3",
                "--log-every", "10"]
    else:
        # ~100M params: 12 layers x d_model 768 (llama-family reduced)
        save = save or os.path.join(tempfile.mkdtemp(prefix="fastdecode_"),
                                    "fastdecode_100m.npz")
        argv = ["--arch", "granite-3-8b", "--reduced", "--layers", "12",
                "--d-model", "768", "--steps", str(steps or 300),
                "--batch", "8", "--seq", "256", "--lr", "3e-3", "--remat",
                "--log-every", "10"]
    if save:
        argv += ["--save", save]
    return argv + ["--device", device]


def main(argv=None, params=None):
    """Runs the train launcher; returns {"argv", "state", "losses"}: its
    argv, its final TrainState and every step's loss.
    ``params`` is unused (the launcher draws its own weights from
    ``--seed``), taken for the examples' common signature."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--save", default="",
                    help="checkpoint path (default: a temp file for the "
                         "~100M run, none for --quick)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    targv = build_argv(args.quick, args.steps, args.save, args.device)
    state, losses = T.main(targv)
    return {"argv": targv, "state": state, "losses": losses}


if __name__ == "__main__":
    main()
