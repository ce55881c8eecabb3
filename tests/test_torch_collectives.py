"""The port's distributed decode and MoE on a 2x2 ('data' x 'model') gloo
world of 4 CPU processes, against the JAX package on a 2x2 mesh of host
devices, on the same numpy weights.

The JAX side runs in a subprocess of its own (it needs
``--xla_force_host_platform_device_count=4`` before JAX starts, and the
pytest process has JAX up with one device).  Its mesh is built with
``AxisType.Auto`` axes: jax's default Explicit axes make the reference's
``with_sharding_constraint`` raise, which is why ``tests/test_collectives.py``
fails on this jax; the reference's code itself is run unchanged.
Reduced granite-3-8b (B 4, S 16, cache 20, as ``test_collectives.py``)
for the explicit flash-decode schedule; reduced grok-1-314b at d_model 96
(its d_ff 512 splits over model = 2) for the distributed MoE prefill."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
B, S = 4, 16
TOL_PORT_VS_JAX = 1e-4      # tests/test_torch_model.py's port-vs-repro
TOL_SM = 2e-4               # the reference's fastdecode vs fastdecode_sm
TOL_MESH = 1e-5             # a mesh run against the port's own plain run

JAX_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.core.config import get_arch
from repro.distributed import sharding as SH
from repro.distributed.api import use_rules
from repro.models import model as M

B, S = 4, 16
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
cfg = get_arch("granite-3-8b").reduced(layers=2, d_model=64, vocab=128)
params = M.init_params(jax.random.PRNGKey(0), cfg)
rng = np.random.default_rng(0)
tokens = rng.integers(0, 128, (B, S)).astype(np.int32)
tok = rng.integers(0, 128, (B, 1)).astype(np.int32)
plens = np.full((B,), S, np.int32)
_, state = M.prefill(params, cfg, jnp.asarray(tokens), jnp.asarray(plens),
                     cache_len=S + 4, q_chunk=8, kv_chunk=8)
out["dense"] = {"params": jax.tree.map(np.asarray, params),
                "tokens": tokens, "tok": tok}
out["dense"]["plain"] = np.asarray(
    M.decode_step(params, cfg, state, jnp.asarray(tok))[0])
rules = SH.make_rules("fastdecode_sm", "decode")
def fn(params, state, tokens):
    with use_rules(mesh, rules):
        return M.decode_step(params, cfg, state, tokens)
out["dense"]["sm"] = np.asarray(jax.jit(fn)(params, state,
                                            jnp.asarray(tok))[0])

cfg = get_arch("grok-1-314b").reduced(layers=2, d_model=96, vocab=128)
params = M.init_params(jax.random.PRNGKey(1), cfg)
tokens = rng.integers(0, 128, (B, S)).astype(np.int32)
plens = np.array([16, 12, 9, 16], np.int32)
out["moe"] = {"params": jax.tree.map(np.asarray, params), "tokens": tokens,
              "plens": plens}
out["moe"]["plain"] = np.asarray(M.prefill(
    params, cfg, jnp.asarray(tokens), jnp.asarray(plens), S + 4,
    q_chunk=8, kv_chunk=8)[0])
rules = SH.make_rules("fastdecode", "prefill")
calls = []
import repro.distributed.moe as DM
orig = DM.moe_ffn_distributed
def counted(*a, **k):
    calls.append(1)
    return orig(*a, **k)
DM.moe_ffn_distributed = counted
def pf(params, tokens, plens):
    with use_rules(mesh, rules):
        return M.prefill(params, cfg, tokens, plens, S + 4, q_chunk=8,
                         kv_chunk=8)
out["moe"]["mesh"] = np.asarray(jax.jit(pf)(params, jnp.asarray(tokens),
                                            jnp.asarray(plens))[0])
out["moe"]["ref_distributed_calls"] = len(calls)
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

B, S = 4, 16


def work(rank, inp, outp, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch import bridge
    from repro_torch.core.config import get_arch
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import moe as DM
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.api import use_rules
    from repro_torch.models import model as M
    from repro_torch.training.tree import tree_map

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    model_group = mesh.get_group("model").group_name
    with open(inp, "rb") as f:
        ref = pickle.load(f)
    res = {}

    class Coll(TorchDispatchMode):
        def __init__(self, sink):
            super().__init__()
            self.sink = sink

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if str(func) == "_c10d_functional.all_reduce.default":
                self.sink.append((args[1], tuple(args[0].shape),
                                  args[2] == model_group))
            return out

    sched = []
    orig_combine = C._combine

    def combine(*a, **k):
        with Coll(sched):
            return orig_combine(*a, **k)
    C._combine = combine

    # -- the explicit flash-decode schedule (reduced granite) --
    d = ref["dense"]
    cfg = get_arch("granite-3-8b").reduced(layers=2, d_model=64, vocab=128)
    params = bridge.params_from_numpy(d["params"], cfg, "cpu")
    tokens = torch.from_numpy(d["tokens"])
    tok = torch.from_numpy(d["tok"])
    _, state = M.prefill(params, cfg, tokens, torch.full((B,), S), S + 4,
                         q_chunk=8, kv_chunk=8)

    def copy():
        return tree_map(lambda t: t.clone(), state)
    res["plain"] = M.decode_step(params, cfg, copy(), tok)[0].numpy()
    for strat in ("fastdecode", "fastdecode_sm"):
        rules = SH.make_rules(strat, "decode")
        p = SH.distribute(params, SH.param_shardings(cfg, mesh, rules))
        st = SH.distribute(copy(), SH.state_shardings(cfg, mesh, rules, B,
                                                      S + 4))
        n0 = len(sched)
        with use_rules(mesh, rules):
            logits, st = M.decode_step(p, cfg, st, tok)
        res[strat] = logits.full_tensor().numpy()
        res[strat + "_sched"] = sched[n0:]
        res[strat + "_lengths"] = st["lengths"].full_tensor().numpy()
    res["local_b"] = B // 2
    res["hq"], res["dh"] = cfg.num_heads, cfg.head_dim

    # -- the distributed MoE (reduced grok-1 prefill) --
    m = ref["moe"]
    cfg = get_arch("grok-1-314b").reduced(layers=2, d_model=96, vocab=128)
    params = bridge.params_from_numpy(m["params"], cfg, "cpu")
    tokens = torch.from_numpy(m["tokens"])
    plens = torch.from_numpy(m["plens"])
    res["moe_plain"] = M.prefill(params, cfg, tokens, plens, S + 4,
                                 q_chunk=8, kv_chunk=8)[0].numpy()
    calls = []
    orig = DM.moe_ffn_distributed

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    DM.moe_ffn_distributed = counted
    rules = SH.make_rules("fastdecode", "prefill")
    p = SH.distribute(params, SH.param_shardings(cfg, mesh, rules))
    with use_rules(mesh, rules):
        logits, _ = M.prefill(p, cfg, tokens, plens, S + 4, q_chunk=8,
                              kv_chunk=8)
    res["moe_mesh"] = logits.full_tensor().numpy()
    res["moe_distributed_calls"] = len(calls)
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
    return p


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("collectives"))
    jax_out = os.path.join(tmp, "jax.pkl")
    port_out = os.path.join(tmp, "port.pkl")
    _run(JAX_SCRIPT, [jax_out], tmp)
    _run(PORT_SCRIPT, [jax_out, port_out], tmp)
    with open(jax_out, "rb") as f:
        ref = pickle.load(f)
    with open(port_out, "rb") as f:
        port = pickle.load(f)
    return ref, port


def _err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def test_explicit_schedule_matches_implicit(runs):
    _, port = runs
    assert _err(port["fastdecode"], port["fastdecode_sm"]) < TOL_SM


@pytest.mark.parametrize("strat", ["fastdecode", "fastdecode_sm"])
def test_mesh_decode_matches_plain_decode(runs, strat):
    _, port = runs
    assert port[strat].shape == port["plain"].shape
    assert np.isfinite(port[strat]).all()
    assert _err(port[strat], port["plain"]) < TOL_MESH
    assert (port[strat + "_lengths"] == S + 1).all()


@pytest.mark.parametrize("strat", ["fastdecode", "fastdecode_sm"])
@pytest.mark.parametrize("against", ["plain", "sm"])
def test_mesh_decode_matches_jax(runs, strat, against):
    """Against repro's no-mesh decode_step and repro's fastdecode_sm on an
    Auto-axis 2x2 JAX mesh."""
    ref, port = runs
    assert _err(port[strat], ref["dense"][against]) < TOL_PORT_VS_JAX


def test_explicit_schedule_is_three_reductions_per_layer(runs):
    """Exactly one MAX and two SUM all-reduces over the model sub-group
    per attention layer: [b, Hq] for m and l, [b, Hq, Dh] for acc (b the
    rank's rows); the implicit path runs no part of the schedule."""
    _, port = runs
    b, hq, dh = port["local_b"], port["hq"], port["dh"]
    sched = port["fastdecode_sm_sched"]
    layers = 2
    assert len(sched) == 3 * layers
    assert all(on_model for _, _, on_model in sched)
    got = sorted((op, int(np.prod(shape))) for op, shape, _ in sched)
    want = sorted([("max", b * hq), ("sum", b * hq), ("sum", b * hq * dh)]
                  * layers)
    assert got == want
    assert port["fastdecode_sched"] == []


def test_distributed_moe_matches_jax(runs):
    ref, port = runs
    assert ref["moe"]["ref_distributed_calls"] >= 1
    assert port["moe_distributed_calls"] == 2        # one per layer
    assert _err(port["moe_mesh"], ref["moe"]["mesh"]) < TOL_PORT_VS_JAX
    assert _err(ref["moe"]["mesh"], ref["moe"]["plain"]) < TOL_PORT_VS_JAX


def test_distributed_moe_matches_plain_prefill(runs):
    """At a capacity of the expert count nothing drops, so the local
    dispatch (whose capacity follows the rank's token count) gives the
    no-mesh prefill's logits."""
    _, port = runs
    assert _err(port["moe_mesh"], port["moe_plain"]) < TOL_MESH
