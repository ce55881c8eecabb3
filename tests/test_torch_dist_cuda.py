"""The distributed layer on the card: a world of 1 over NCCL and its (1, 1)
('data', 'model') DeviceMesh.  Decode under the fastdecode, fastdecode_sm
and baseline rules against the plain decode, and a train step under the
train rules with grad_shardings against the plain step (fp32, TF32 off,
reduced qwen3-8b).  A world of more than one rank cannot share one card
over NCCL: tests/test_torch_collectives.py holds the 2x2 world on gloo.
Marked ``cuda``: they skip without a CUDA device.  This file imports no
JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_dist_cuda.py
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch.core.config import get_arch
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.api import implicit_replication, use_rules
from repro_torch.models import model as M
from repro_torch.training.train import loss_and_grads, make_train_step
from repro_torch.training.tree import leaves, tree_map

pytestmark = pytest.mark.cuda
B, S, CACHE = 4, 24, 40


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the NCCL world of 1)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    store = str(tmp_path_factory.mktemp("nccl") / "store")
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1, device_id=dev)
    yield init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def _case():
    cfg = get_arch("qwen3-8b").reduced(layers=2, d_model=64, vocab=128)
    dev = torch.device("cuda", 0)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, 128, (B, S), generator=gen).to(dev)
    tok = torch.randint(0, 128, (B, 1), generator=gen).to(dev)
    return cfg, params, tokens, tok


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


@pytest.mark.parametrize("strategy", ["fastdecode", "fastdecode_sm",
                                      "baseline"])
def test_mesh_decode_matches_plain(mesh, strategy):
    cfg, params, tokens, tok = _case()
    plens = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    _, state = M.prefill(params, cfg, tokens, plens, CACHE)
    want, _ = M.decode_step(params, cfg, _clone(state), tok)
    rules = SH.make_rules(strategy, "decode")
    p = SH.distribute(params, SH.param_shardings(cfg, mesh, rules))
    st = SH.distribute(_clone(state), SH.state_shardings(cfg, mesh, rules,
                                                         B, CACHE))
    with use_rules(mesh, rules):
        got, st = M.decode_step(p, cfg, st, tok)
    got = got.full_tensor()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert (st["lengths"].full_tensor() == S + 1).all()


def test_mesh_train_step_matches_plain(mesh):
    """Loss and grads under the train rules == plain (fp32); then the
    step with grad_shardings runs and gives the plain step's loss."""
    cfg, params, tokens, _ = _case()
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1),
             "mask": torch.ones(tokens.shape, device=tokens.device)}
    (loss, _), grads = loss_and_grads(params, cfg, batch, q_chunk=8,
                                      kv_chunk=8)
    rules = SH.make_rules("fastdecode", "train", train=True)
    p_sh = SH.param_shardings(cfg, mesh, rules)
    p = SH.distribute(_clone(params), p_sh)
    b = {k: SH.distribute_leaf(v, SH.data_sharding(
        mesh, rules, v.shape, ("batch", "seq"))) for k, v in batch.items()}
    with use_rules(mesh, rules), implicit_replication():
        (loss2, _), grads2 = loss_and_grads(p, cfg, b, q_chunk=8,
                                            kv_chunk=8)
    assert abs(float(loss2.full_tensor()) - float(loss)) <= \
        1e-5 * abs(float(loss))
    for a, w in zip(leaves(grads2), leaves(grads)):
        torch.testing.assert_close(a.full_tensor(), w, rtol=1e-4, atol=1e-5)
    init, step = make_train_step(cfg, peak_lr=1e-2, warmup=1, q_chunk=8,
                                 kv_chunk=8, grad_shardings=p_sh)
    with use_rules(mesh, rules):
        _, m = step(init(p), b)
    assert abs(float(m["loss"].full_tensor()) - float(loss)) <= \
        1e-5 * abs(float(loss))
