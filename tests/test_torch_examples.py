"""The port's twins of the JAX package's three examples
(``repro_torch.examples``), run on the CPU against the JAX package:

* ``quickstart``: on ``repro``'s ``init_params(PRNGKey(0))`` weights,
  carried over by ``repro_torch.bridge``, its hetero and colocated greedy
  tokens equal those of ``repro``'s ``ColocatedEngine`` on the same
  weights and prompt (exact: fp32);
* ``serve_continuous --requests 6 --max-new 6``: on bridged weights,
  each request's generated tokens equal those of ``repro``'s
  ``ServingEngine`` at the example's settings (loadctl admission,
  prefill chunks of 8, 2 R-workers, 2 micro-batches), and the Fig. 7
  resident-length trace is ``repro``'s step for step;
* ``train_small --quick --steps 3``: three finite losses, and a
  checkpoint the port's ``checkpoint.load`` reads back bit for bit;
* each module runs as ``python -m`` and defaults to the card (it
  raises without one)."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import ModelConfig as JModelConfig
from repro.core.hetero import ColocatedEngine as JColocated
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.request import Request as JRequest
from repro_torch import bridge
from repro_torch.examples import quickstart, serve_continuous, train_small
from repro_torch.training import checkpoint as CK
from repro_torch.training.tree import leaves, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bridged(tcfg):
    """(JAX cfg, JAX params, port params): ``repro``'s PRNGKey(0) weights
    of the example's config, carried over to the port."""
    jc = JModelConfig(**dataclasses.asdict(tcfg))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jc, jp, tp


def test_quickstart_matches_jax_colocated():
    jc, jp, tp = _bridged(quickstart.CFG)
    got = quickstart.main(["--device", "cpu"], params=tp)
    prompt = quickstart.PROMPT
    B, S, GEN = 2, len(prompt), quickstart.GEN
    tokens = jnp.asarray(np.stack([prompt, prompt[::-1]]))
    ref = JColocated(jp, jc, batch=B, cache_len=S + GEN + 1)
    ref.load_prefill(tokens, jnp.full((B,), S))
    tok, want = tokens[:, -1:], []
    for _ in range(GEN):
        tok = jnp.argmax(ref.decode_step(tok), -1)[:, None].astype(
            jnp.int32)
        want.append(np.asarray(tok[:, 0]))
    want = np.stack(want).T
    np.testing.assert_array_equal(got["fastdecode"], want)
    np.testing.assert_array_equal(got["colocated"], want)


def test_quickstart_seeded_weights_run(capsys):
    out = quickstart.main(["--device", "cpu"])
    assert out["fastdecode"].shape == (2, quickstart.GEN)
    assert "OK" in capsys.readouterr().out


def _jax_serve(jc, jp, requests, max_new):
    """examples/serve_continuous.py's engine and requests on ``repro``."""
    rng = np.random.default_rng(0)
    eng = JServingEngine(jp, jc, batch=8, cache_len=128, backend="hetero",
                         admission="loadctl", target_len=8 + max_new,
                         interval=6, num_r_workers=2, num_microbatches=2,
                         kv_chunk=128, prefill_chunk=8)
    try:
        for i in range(requests):
            plen = int(rng.integers(4, 12))
            eng.submit(JRequest(rid=i, prompt=rng.integers(
                1, jc.vocab_size, plen).astype(np.int32),
                max_new_tokens=max_new))
        done = eng.run(max_steps=50_000)
    finally:
        eng.close()
    return ({r.rid: list(r.generated) for r in done},
            [r.resident_len for r in eng.records])


def test_serve_continuous_matches_jax(capsys):
    jc, jp, tp = _bridged(serve_continuous.CFG)
    done, records = serve_continuous.main(
        ["--requests", "6", "--max-new", "6", "--device", "cpu"], params=tp)
    want, want_trace = _jax_serve(jc, jp, 6, 6)
    got = {r.rid: list(r.generated) for r in done}
    assert sorted(got) == list(range(6))
    assert all(len(t) == 6 for t in got.values())
    assert got == want
    assert [r.resident_len for r in records] == want_trace
    printed = capsys.readouterr().out
    assert "served 6 requests / 36 tokens" in printed
    assert "on this host" in printed and "Fig. 7" in printed


def test_train_small_quick_runs_and_saves(tmp_path):
    path = str(tmp_path / "quick.npz")
    out = train_small.main(["--quick", "--steps", "3", "--save", path,
                            "--device", "cpu"])
    assert out["argv"][:12] == ["--arch", "granite-3-8b", "--reduced",
                                "--layers", "4", "--d-model", "256",
                                "--steps", "3", "--batch", "8", "--seq"]
    losses = out["losses"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    final = tree_map(lambda x: x.to_local() if hasattr(x, "to_local")
                     else x, out["state"].params)
    back = CK.load(path, final)
    for a, b in zip(leaves(back), leaves(final)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_small_argv_matches_the_jax_example():
    """The ~100M run's argv is the JAX example's, its fixed /tmp path
    replaced by a file in a fresh temp directory."""
    argv = train_small.build_argv(quick=False, device="cpu")
    save = argv[argv.index("--save") + 1]
    assert os.path.basename(save) == "fastdecode_100m.npz"
    assert not save.startswith("/tmp/fastdecode_100m")
    assert argv[:argv.index("--save")] == [
        "--arch", "granite-3-8b", "--reduced", "--layers", "12",
        "--d-model", "768", "--steps", "300", "--batch", "8", "--seq",
        "256", "--lr", "3e-3", "--remat", "--log-every", "10"]
    assert argv[-2:] == ["--device", "cpu"]
    quick = train_small.build_argv(quick=True, device="cpu")
    assert "--save" not in quick and "--remat" not in quick
    assert quick[quick.index("--steps") + 1] == "60"


@pytest.mark.parametrize("name", ["quickstart", "serve_continuous",
                                  "train_small"])
def test_module_defaults_to_the_card(name):
    """``python -m repro_torch.examples.<name>`` with no ``--device``
    wants the card and, without one, exits non-zero naming CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    argv = ["--quick", "--steps", "1"] if name == "train_small" else []
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}"]
                       + argv, capture_output=True, text=True, env=env,
                       timeout=120, cwd=ROOT)
    assert p.returncode != 0
    assert "CUDA" in p.stderr
