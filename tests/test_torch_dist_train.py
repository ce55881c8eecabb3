"""The port's training step on a 2x2 ('data' x 'model') gloo world of 4 CPU
processes, against the JAX package's on a 2x2 mesh of host devices, on
the same numpy weights and batch, under
``make_rules("fastdecode", "train", train=True)``.

What a multi-rank step adds to the one-rank step and is held here: the
grads of params laid out over both axes (partial sums reduced by the
redistributions' backward), their move to ``grad_shardings``, AdamW's
moments on DTensors, the masked loss mean over a data-sharded batch, and
(reduced grok-1-314b at d_model 96, whose d_ff 512 splits over model = 2)
``moe_ffn_distributed``'s backward through its all-gather and
reduce-scatter.

The JAX side runs in a subprocess of its own with four host devices and
an ``AxisType.Auto`` mesh (jax's default Explicit axes make the
reference's ``with_sharding_constraint`` raise); the reference's code is
run unchanged.  Independently of JAX, the mesh grads are also held
against plain autograd of the loss the mesh computes: the distributed
MoE's aux loss is the mean of each data rank's aux over its own rows.

fp32 reduced configs; loss within 1e-5 relative, every grad leaf and
first moment within rtol 1e-4, atol 1e-5 (the moment's atol scaled by
its 1 - b1), three steps' losses and grad norms within 1e-4 relative
(``tests/test_torch_train_forward.py``'s tolerances)."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
MU_TOL = dict(rtol=1e-4, atol=1e-6)       # mu = (1 - b1) g after step 1
TRAJ_RTOL = 1e-4
CASES = ("granite-3-8b", "grok-1-314b")

JAX_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.core.config import get_arch
from repro.distributed import sharding as SH
from repro.distributed.api import use_rules
from repro.models import model as M
from repro.training import train as JT
from repro_torch.training.tree import leaves_with_path

B, S = 4, 16
KW = dict(q_chunk=8, kv_chunk=8)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
rules = SH.make_rules("fastdecode", "train", train=True)
rng = np.random.default_rng(2)
out = {}
for seed, (arch, d_model) in enumerate((("granite-3-8b", 64),
                                        ("grok-1-314b", 96))):
    cfg = get_arch(arch).reduced(layers=2, d_model=d_model, vocab=128)
    params = M.init_params(jax.random.PRNGKey(seed + 2), cfg)
    tokens = rng.integers(0, 128, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[1, 11:] = 0
    mask[2, 5:] = 0
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, 1),
             "mask": mask}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def lg(p, b):
        with use_rules(mesh, rules):
            return jax.value_and_grad(JT.loss_fn, has_aux=True)(
                p, cfg, b, **KW)
    (loss, m), grads = jax.jit(lg)(params, jb)
    init, step = JT.make_train_step(
        cfg, peak_lr=1e-2, warmup=2, total_steps=6,
        grad_shardings=SH.param_shardings(cfg, mesh, rules), **KW)

    def fn(st, b):
        with use_rules(mesh, rules):
            return step(st, b)
    jstep = jax.jit(fn)
    st = init(params)
    traj = []
    for i in range(3):
        st, mm = jstep(st, jb)
        traj.append((float(mm["loss"]), float(mm["grad_norm"])))
        if i == 0:
            mu1 = dict(leaves_with_path(jax.tree.map(np.asarray,
                                                     st.opt.mu)))
    out[arch] = {"params": jax.tree.map(np.asarray, params),
                 "batch": batch, "loss": float(loss),
                 "ce": float(m["ce"]), "aux": float(m["aux"]),
                 "grads": dict(leaves_with_path(
                     jax.tree.map(np.asarray, grads))),
                 "traj": traj, "mu1": mu1}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
print("JAX_DONE")
"""

PORT_SCRIPT = r"""
import os, pickle, sys, tempfile
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

KW = dict(q_chunk=8, kv_chunk=8)


def work(rank, inp, outp, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import bridge
    from repro_torch.core.config import get_arch
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.api import use_rules
    from repro_torch.models import model as M
    from repro_torch.training import train as TT
    from repro_torch.training.tree import leaves, leaves_with_path, tree_map

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = SH.make_rules("fastdecode", "train", train=True)
    with open(inp, "rb") as f:
        ref = pickle.load(f)

    def full(tree):
        # a copy: a replicated DTensor's full_tensor is its local tensor,
        # which the next step updates in place
        return {p: t.full_tensor().clone().numpy()
                for p, t in leaves_with_path(tree)}

    res = {}
    for arch, d_model in (("granite-3-8b", 64), ("grok-1-314b", 96)):
        r = ref[arch]
        cfg = get_arch(arch).reduced(layers=2, d_model=d_model, vocab=128)
        p_sh = SH.param_shardings(cfg, mesh, rules)
        params = SH.distribute(bridge.params_from_numpy(r["params"], cfg,
                                                        "cpu"), p_sh)
        plain = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
        batch = {k: SH.distribute_leaf(v, SH.data_sharding(
            mesh, rules, v.shape, ("batch", "seq")))
            for k, v in plain.items()}
        with use_rules(mesh, rules):
            (loss, m), grads = TT.loss_and_grads(params, cfg, batch, **KW)
        got = {"loss": float(loss.full_tensor()),
               "ce": float(m["ce"].full_tensor()),
               "aux": float(m["aux"].full_tensor()) if cfg.num_experts
               else float(m["aux"]),
               "grads": full(grads)}

        init, step = TT.make_train_step(cfg, peak_lr=1e-2, warmup=2,
                                        total_steps=6, grad_shardings=p_sh,
                                        **KW)
        with use_rules(mesh, rules):
            st = init(params)
        traj = []
        for i in range(3):
            with use_rules(mesh, rules):
                st, mm = step(st, batch)
            traj.append((float(mm["loss"].full_tensor()),
                         float(mm["grad_norm"].full_tensor())))
            if i == 0:
                got["mu1"] = full(st.opt.mu)
        got["traj"] = traj
        got["layouts_kept"] = all(
            tuple(t.placements) == sh.placements == tuple(mu.placements)
            for t, mu, sh in zip(leaves(st.params), leaves(st.opt.mu),
                                 leaves(p_sh)))

        # the loss the mesh computes, by plain autograd on one rank: the
        # CE over the whole batch, the MoE aux averaged over the data
        # ranks' rows (each rank's dispatch sees its own rows only)
        live = tree_map(lambda p: p.detach().requires_grad_(True),
                        bridge.params_from_numpy(r["params"], cfg, "cpu"))
        _, mt = TT.loss_fn(live, cfg, plain, **KW)
        aux = sum(M.train_forward(live, cfg, plain["tokens"][rows], None,
                                  **KW)[1]
                  for rows in (slice(0, 2), slice(2, 4))) / 2
        total = mt["ce"] + cfg.router_aux_loss * aux
        g = torch.autograd.grad(total, leaves(live), allow_unused=True)
        got["oracle"] = {p: (torch.zeros_like(x) if gi is None else gi)
                         .numpy() for (p, x), gi
                         in zip(leaves_with_path(live), g)}
        got["oracle_loss"] = float(total.detach())
        res[arch] = got
    if rank == 0:
        with open(outp, "wb") as f:
            pickle.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    store = os.path.join(tempfile.mkdtemp(dir=os.path.dirname(sys.argv[2])),
                         "store")
    mp.spawn(work, args=(sys.argv[1], sys.argv[2], store), nprocs=4)
    print("PORT_DONE")
"""


def _run(script, args, tmp):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["OMP_NUM_THREADS"] = "1"
    env.pop("XLA_FLAGS", None)
    path = os.path.join(tmp, "script.py")
    with open(path, "w") as f:
        f.write(script)
    p = subprocess.run([sys.executable, path] + args, capture_output=True,
                       text=True, timeout=600, env=env, cwd=ROOT)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-6000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist_train"))
    jax_out = os.path.join(tmp, "jax.pkl")
    port_out = os.path.join(tmp, "port.pkl")
    _run(JAX_SCRIPT, [jax_out], tmp)
    _run(PORT_SCRIPT, [jax_out, port_out], tmp)
    with open(jax_out, "rb") as f:
        ref = pickle.load(f)
    with open(port_out, "rb") as f:
        port = pickle.load(f)
    return ref, port


def _leaves_close(got, want, tol):
    assert set(got) == set(want)
    for path in sorted(want):
        np.testing.assert_allclose(got[path], want[path], err_msg=str(path),
                                   **tol)


@pytest.mark.parametrize("arch", CASES)
def test_mesh_loss_matches_jax(runs, arch):
    ref, port = runs
    r, p = ref[arch], port[arch]
    assert p["loss"] == pytest.approx(r["loss"], rel=LOSS_RTOL)
    assert p["ce"] == pytest.approx(r["ce"], rel=LOSS_RTOL)
    assert p["aux"] == pytest.approx(r["aux"], rel=LOSS_RTOL, abs=1e-7)
    if arch.startswith("grok"):
        # the router's load-balance loss is live and enters the total
        assert r["aux"] > 0.5


@pytest.mark.parametrize("arch", CASES)
def test_mesh_grads_match_jax(runs, arch):
    """Every grad leaf of the 2x2 step against repro's on its Auto mesh."""
    ref, port = runs
    _leaves_close(port[arch]["grads"], ref[arch]["grads"], GRAD_TOL)
    # every leaf learns: a lost partial sum would show as zeros
    for path, g in port[arch]["grads"].items():
        assert np.abs(g).max() > 0, path


@pytest.mark.parametrize("arch", CASES)
def test_mesh_grads_match_plain_autograd(runs, arch):
    """The mesh grads against plain autograd of the same loss on one rank
    (no collective, no JAX)."""
    _, port = runs
    p = port[arch]
    assert p["loss"] == pytest.approx(p["oracle_loss"], rel=LOSS_RTOL)
    _leaves_close(p["grads"], p["oracle"], GRAD_TOL)


@pytest.mark.parametrize("arch", CASES)
def test_mesh_train_steps_track_jax(runs, arch):
    """Three make_train_step(grad_shardings=...) steps (warmup 2): losses
    and grad norms against repro's, the first moments after step 1, and
    the params and moments still in the params' layouts."""
    ref, port = runs
    r, p = ref[arch], port[arch]
    for (gl, gn), (wl, wn) in zip(p["traj"], r["traj"]):
        assert gl == pytest.approx(wl, rel=TRAJ_RTOL)
        assert gn == pytest.approx(wn, rel=TRAJ_RTOL)
    assert p["traj"][0][0] == pytest.approx(p["loss"], rel=LOSS_RTOL)
    assert p["traj"][-1][0] < p["traj"][0][0]
    _leaves_close(p["mu1"], r["mu1"], MU_TOL)
    assert p["layouts_kept"]
