"""The port's sharding rules (``repro_torch.distributed``) against the JAX
package's: twins of ``tests/test_sharding.py`` on the same mock meshes,
and, for every config at full size on the 16x16 and 2x16x16 meshes, the
per-leaf spec of every param and decode-state leaf for each strategy,
mode and zero3 setting."""
from types import SimpleNamespace

import jax
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import repro.distributed.sharding as RSH
from repro.core.config import get_arch as ref_get_arch
from repro.distributed.api import logical_to_spec as ref_logical_to_spec
from repro_torch.core.config import get_arch, list_archs
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.api import P, logical_to_spec, placements
from repro_torch.training.tree import leaves, leaves_with_path

MESH = SimpleNamespace(shape={"data": 16, "model": 16})
MESH3 = SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16})


def test_divisibility_fallback():
    rules = {"kv_heads": "model", "batch": ("pod", "data")}
    # 8 kv heads cannot shard over model=16 -> replicated
    spec = logical_to_spec(MESH, rules, (128, 32768, 8, 128),
                           ("batch", None, "kv_heads", None))
    assert spec == P("data", None, None, None)
    # 32 kv heads can
    spec = logical_to_spec(MESH, rules, (128, 32768, 32, 128),
                           ("batch", None, "kv_heads", None))
    assert spec == P("data", None, "model", None)


def test_multi_axis_assignment():
    rules = {"ff": ("model", "pod", "data")}
    spec = logical_to_spec(MESH3, rules, (6144, 32768), (None, "ff"))
    assert spec == P(None, ("model", "pod", "data"))
    # partially divisible: model(16) then pod(2) fit 256, data(16) does not
    spec = logical_to_spec(MESH3, rules, (6144, 256), (None, "ff"))
    assert spec == P(None, ("model", "pod"))


def test_axis_used_once():
    rules = {"batch": "data", "expert": "data"}
    spec = logical_to_spec(MESH, rules, (16, 16), ("batch", "expert"))
    assert spec[0] == "data" and spec[1] is None


def test_missing_mesh_axis_skipped():
    rules = {"batch": ("pod", "data")}
    spec = logical_to_spec(MESH, rules, (32,), ("batch",))
    assert spec == P("data")


def test_fastdecode_vs_baseline_cache_rules():
    fd = SH.make_rules("fastdecode", "decode")
    bl = SH.make_rules("baseline", "decode")
    assert fd["cache"] == "model" and fd["kv_heads"] is None
    assert bl["cache"] is None and bl["kv_heads"] == "model"


def test_weights_stay_decode_rules():
    r = SH.make_rules("fastdecode", "decode", zero3=True)
    assert r["batch"] is None                 # activations replicated/psum
    assert r["embed"] == ("pod", "data")      # weights fully distributed
    assert r["kv_batch"] == ("pod", "data")   # KV still batch-sharded


def test_train_rules_use_sp_and_wide_weight_sharding():
    r = SH.make_rules("fastdecode", "train", zero3=True, train=True)
    assert r["seq"] == "model"                # sequence parallelism
    assert r["ff"] == ("model", "pod", "data")
    assert r["layer"] is None                 # layer dim never sharded


STRATEGIES = ("fastdecode", "fastdecode_sm", "baseline", "dp")
MODES = ("train", "prefill", "decode")


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("zero3", [False, True])
def test_rules_equal_the_reference(strategy, mode, zero3):
    assert SH.make_rules(strategy, mode, zero3=zero3,
                         train=mode == "train") == \
        RSH.make_rules(strategy, mode, zero3=zero3, train=mode == "train")


@pytest.fixture(scope="module")
def mesh11():
    """A real (1, 1) DeviceMesh over a gloo world of 1."""
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    from torch.distributed.device_mesh import init_device_mesh
    yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    if made:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["granite-3-8b", "grok-1-314b",
                                  "mamba2-2.7b", "whisper-medium"])
def test_param_sharding_trees_build(arch, mesh11):
    """Every arch's param tree gets a sharding per leaf on a real mesh,
    in the tree of ``param_shapes``, whose leaves match ``init_params``'
    (checked on the reduced config: structure, shapes, dtypes)."""
    cfg = get_arch(arch)
    rules = SH.make_rules("fastdecode", "decode")
    tree = SH.param_shardings(cfg, mesh11, rules)
    shapes = SH.param_shapes(cfg)
    assert [p for p, _ in leaves_with_path(shapes)] == \
        [p for p, _ in leaves_with_path(tree)]
    assert all(isinstance(s, SH.Sharding) for s in leaves(tree))
    small = cfg.reduced(layers=2, d_model=64)
    real = SH.M.init_params(small, torch.Generator().manual_seed(0), "cpu")
    assert [(p, tuple(x.shape), x.dtype)
            for p, x in leaves_with_path(SH.param_shapes(small))] == \
        [(p, tuple(x.shape), x.dtype) for p, x in leaves_with_path(real)]


def test_state_sharding_kv_layout(mesh11):
    cfg = get_arch("granite-3-8b")
    rules = SH.make_rules("fastdecode", "decode")
    tree = SH.state_shardings(cfg, mesh11, rules, batch=8, cache_len=64)
    assert [p for p, _ in leaves_with_path(tree)] == \
        [p for p, _ in leaves_with_path(SH.state_shapes(cfg, 8, 64))]


def test_placements_of_specs():
    mesh = SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16})
    assert placements(mesh, P("data", None, "model")) == \
        (Replicate(), Shard(0), Shard(2))
    # one dim over several axes: each of its mesh dims splits that dim
    assert placements(mesh, P(None, ("model", "pod", "data"))) == \
        (Shard(1), Shard(1), Shard(1))
    assert placements(mesh, P()) == (Replicate(),) * 3


def test_auto_zero3_thresholds():
    """The reference's thresholds at the v5e's 16 GB."""
    mesh = SimpleNamespace(shape={"data": 16, "model": 16}, size=256)
    for arch in list_archs():
        assert SH.auto_zero3(get_arch(arch), mesh, hbm_bytes=16e9) == \
            RSH.auto_zero3(ref_get_arch(arch), mesh), arch
    assert SH.auto_zero3(get_arch("grok-1-314b"), mesh, hbm_bytes=16e9)
    assert SH.auto_zero3(get_arch("deepseek-67b"), mesh, hbm_bytes=16e9)
    assert not SH.auto_zero3(get_arch("granite-3-8b"), mesh,
                             hbm_bytes=16e9)
    assert not SH.auto_zero3(get_arch("mamba2-2.7b"), mesh, hbm_bytes=16e9)


def test_auto_zero3_on_the_h100_default():
    """The port's default is the H100's 80 GB: the same rule (TP-only
    bf16 weights over 25% of the device) then picks zero3 for grok-1
    (39.6 GB a device at model = 16) and opt-175b (21.9 GB), and no
    longer for deepseek-67b (8.4 GB)."""
    mesh = SimpleNamespace(shape={"data": 16, "model": 16})
    for arch in list_archs():
        cfg = get_arch(arch)
        want = cfg.param_count() * 2 / 16 > 0.25 * 80e9
        assert SH.auto_zero3(cfg, mesh) == want, arch
    assert SH.auto_zero3(get_arch("grok-1-314b"), mesh)
    assert SH.auto_zero3(get_arch("opt-175b"), mesh)
    assert not SH.auto_zero3(get_arch("deepseek-67b"), mesh)


# ---------------------------------------------------------------------------
# per-leaf specs of every config against the reference's
# ---------------------------------------------------------------------------
_REF_SHAPES = {}


def _ref_shapes(arch):
    if arch not in _REF_SHAPES:
        cfg = ref_get_arch(arch)
        _REF_SHAPES[arch] = (RSH.param_shapes(cfg),
                             RSH.state_shapes(cfg, 128, 32768))
    return _REF_SHAPES[arch]


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_leaf_specs_equal_the_reference(arch, monkeypatch):
    """Every param and state leaf: the port's spec == the one the
    reference's ``_tree_shardings`` (its ``_param_axes`` / ``_state_axes``
    and ``logical_to_spec``) gives, for four strategies x three modes x
    zero3 on and off, on both production meshes."""
    monkeypatch.setattr(RSH, "NamedSharding", lambda mesh, spec: spec)
    cfg = get_arch(arch)
    ref_p, ref_s = _ref_shapes(arch)
    port_p, port_s = SH.param_shapes(cfg), SH.state_shapes(cfg, 128, 32768)
    assert [tuple(x.shape) for x in leaves(port_p)] == \
        [tuple(x.shape) for x in jax.tree.leaves(ref_p)]
    assert [tuple(x.shape) for x in leaves(port_s)] == \
        [tuple(x.shape) for x in jax.tree.leaves(ref_s)]
    n = 0
    for mesh in (MESH, MESH3):
        for strategy in STRATEGIES:
            for mode in MODES:
                for zero3 in (False, True):
                    rules = SH.make_rules(strategy, mode, zero3=zero3,
                                          train=mode == "train")
                    for shapes, ref, axes, raxes in (
                            (port_p, ref_p, SH._param_axes,
                             RSH._param_axes),
                            (port_s, ref_s, SH._state_axes,
                             RSH._state_axes)):
                        got = [tuple(s.spec) for s in leaves(
                            SH._tree_shardings(shapes, mesh, rules, axes))]
                        want = [tuple(s) for s in jax.tree.leaves(
                            RSH._tree_shardings(ref, mesh, rules, raxes),
                            is_leaf=lambda x: isinstance(
                                x, jax.sharding.PartitionSpec))]
                        assert got == want, (mesh.shape, strategy, mode,
                                             zero3)
                        n += len(got)
    assert n > 0


def test_logical_to_spec_equals_the_reference():
    rules = SH.make_rules("fastdecode", "decode", zero3=True)
    for mesh in (MESH, MESH3):
        for shape, axes in (((128, 32768, 8, 128),
                             ("kv_batch", "cache", "kv_heads", "head_dim")),
                            ((6144, 32768), ("embed", "ff")),
                            ((49155, 4096), ("vocab", "embed"))):
            assert tuple(logical_to_spec(mesh, rules, shape, axes)) == \
                tuple(ref_logical_to_spec(mesh, rules, shape, axes))
