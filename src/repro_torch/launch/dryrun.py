"""Multi-pod dry-run: run every (arch x shape x mesh x strategy) combination
through the port's real entry point in a fake world of 256 or 512 ranks,
and count what one device does: its flops and its collective bytes.

Usage:
    python -m repro_torch.launch.dryrun --arch granite-3-8b --shape decode_32k
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
    python -m repro_torch.launch.dryrun --list

Each combination runs as rank 0 of a world on torch's fake process group
(``FakeStore``: collectives return at once, moving nothing).  Params,
optimizer state, decode state and batch are DTensors of ``meta`` tensors
laid out by ``distributed.sharding``, so nothing is allocated and nothing
is computed: the ops run for their shapes.  The entry point is the one a
user calls: ``decode_step``, ``prefill``, or ``make_train_step(remat=True,
grad_shardings=...)``'s step with its backward.

A dispatch mode below DTensor (``_Counter``) sees the ops each rank runs
on its local blocks:

- ``flops``: per device, from ``torch.utils.flop_counter``'s formulas on
  the local shapes (a DTensor-level count would give the global op's);
- ``collectives``: each functional collective's RESULT bytes, per device,
  by kind (``bytes_by_op``, ``counts``), and ``wire_bytes`` with the
  reference's ring factors (``_COLL_FACTOR``).  An all-to-all that sends
  to one peer only is a permute.  Every layer runs (a Python loop, not a
  scan), so the counts need no trip-count scaling;
- ``argument_size_in_bytes``: the local blocks of every argument.

XLA's ``bytes_accessed`` and ``temp_size_in_bytes`` have no counterpart
here (nothing is compiled, nothing allocated): those keys are left out.
A failing combination is recorded with ``ok: false`` and its error.
Records go to ``build/dryrun_torch/`` (or ``--out``), one JSON file per
combination; never to the JAX package's ``benchmarks/results/dryrun``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from dataclasses import replace

import torch

from repro_torch.core.config import (ASSIGNED_ARCHS, SHAPES, SKIPS,
                                     ModelConfig, get_arch)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                       "dryrun_torch")

LONG_WINDOW = 8192       # sliding-window variant for dense archs @ long_500k


# ---------------------------------------------------------------------------
# config variants per shape
# ---------------------------------------------------------------------------
def variant_for_shape(cfg: ModelConfig, shape_name: str) -> ModelConfig:
    """long_500k needs sub-quadratic attention: archs with attention
    switch to the sliding-window decode variant; SSM / hybrid archs run
    natively."""
    if shape_name == "long_500k" and cfg.window == 0 and \
            any(k in cfg.pattern for k in ("attn",)):
        return replace(cfg, window=LONG_WINDOW)
    return cfg


# ---------------------------------------------------------------------------
# input specs (meta stand-ins; no allocation)
# ---------------------------------------------------------------------------
def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str):
    """{name: meta tensor} of the mode's entry-point inputs."""
    sc = SHAPES[shape_name]
    b, s = sc.global_batch, sc.seq_len
    out = {}
    if sc.mode == "train":
        out["tokens"] = _sds((b, s), torch.int32)
        out["targets"] = _sds((b, s), torch.int32)
        out["mask"] = _sds((b, s), torch.float32)
    elif sc.mode == "prefill":
        out["tokens"] = _sds((b, s), torch.int32)
        out["prompt_lens"] = _sds((b,), torch.int32)
    else:  # decode: ONE new token against a seq_len cache
        out["tokens"] = _sds((b, 1), torch.int32)
    if cfg.frontend != "none" and sc.mode in ("train", "prefill"):
        dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
        out["enc_feats"] = _sds((b, cfg.encoder_seq, cfg.encoder_d_model), dt)
    return out


# ---------------------------------------------------------------------------
# collective and flop accounting
# ---------------------------------------------------------------------------
# effective bytes-on-the-wire multipliers (ring algorithms, approximate)
_COLL_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

_COLL_KIND = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
              "all_gather_into_tensor": "all-gather",
              "all_gather_into_tensor_coalesced": "all-gather",
              "reduce_scatter_tensor": "reduce-scatter",
              "reduce_scatter_tensor_coalesced": "reduce-scatter",
              "all_to_all_single": "all-to-all"}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def collective_kind(func, args):
    """The reference's name of a functional collective op, or None."""
    name = func._overloadpacket.__name__
    ns = func.namespace
    if ns != "_c10d_functional" or name not in _COLL_KIND:
        return None
    kind = _COLL_KIND[name]
    if kind == "all-to-all":
        out_splits, in_splits = args[1], args[2]
        if sum(1 for n in in_splits if n) == 1 and \
                sum(1 for n in out_splits if n) == 1:
            kind = "collective-permute"     # one peer each way
    return kind


def collective_bytes(records):
    """records: (kind, result bytes) pairs -> the reference's summary."""
    per_op = {k: 0 for k in _COLL_FACTOR}
    counts = {k: 0 for k in _COLL_FACTOR}
    for kind, b in records:
        per_op[kind] += b
        counts[kind] += 1
    total_wire = sum(per_op[k] * _COLL_FACTOR[k] for k in per_op)
    return {"bytes_by_op": per_op, "counts": counts,
            "wire_bytes": total_wire}


def _counter_class():
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _Counter(TorchDispatchMode):
        """Counts the ops on local blocks: DTensor-level ops are passed on
        (``NotImplemented``) to DTensor, whose local ops come back here;
        the fake-tensor ops of DTensor's shape propagation are skipped."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.colls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if func is torch.ops.aten.equal.default and \
                    args[0].device.type == "meta":
                # DTensor checks that two uses of one gather mask agree;
                # meta tensors hold no values to compare
                return args[0].shape == args[1].shape
            out = func(*args, **kwargs)
            if any(issubclass(t, FakeTensor) for t in types):
                return out
            kind = collective_kind(func, args)
            if kind is not None:
                self.colls.append((kind, _nbytes(out)))
            elif func._overloadpacket in flop_registry:
                self.flops += flop_registry[func._overloadpacket](
                    *args, **kwargs, out_val=out)
            return out

    return _Counter


# ---------------------------------------------------------------------------
# build + run one combination
# ---------------------------------------------------------------------------
def _local_bytes(tree) -> int:
    from repro_torch.training.tree import leaves
    return sum(x.to_local().numel() * x.element_size()
               if hasattr(x, "to_local") else x.numel() * x.element_size()
               for x in leaves(tree))


def run_combo(arch: str, shape_name: str, mesh, strategy: str,
              kv_chunk: int = 2048, q_chunk: int = 1024):
    """Runs one combination on ``mesh`` under the counter; returns (cfg,
    counter, meta, argument bytes)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.api import use_rules
    from repro_torch.models import model as M
    from repro_torch.training.train import make_train_step

    cfg = variant_for_shape(get_arch(arch), shape_name)
    sc = SHAPES[shape_name]
    zero3 = SH.auto_zero3(cfg, mesh)
    rules = SH.make_rules(strategy, sc.mode, zero3=zero3,
                          train=(sc.mode == "train"))
    specs = input_specs(cfg, shape_name)
    p_sh = SH.param_shardings(cfg, mesh, rules)
    params = SH.distribute(SH.param_shapes(cfg), p_sh)

    def data(key, axes):
        x = specs[key]
        return SH.distribute_leaf(x, SH.data_sharding(mesh, rules, x.shape,
                                                      axes))

    counter = _counter_class()()
    if sc.mode == "train":
        init_state, train_step = make_train_step(
            cfg, remat=True, q_chunk=q_chunk, kv_chunk=kv_chunk,
            grad_shardings=p_sh)
        batch = {k: data(k, ("batch", "enc_seq", None) if k == "enc_feats"
                         else ("batch", "seq")) for k in specs}
        with use_rules(mesh, rules):
            state = init_state(params)
            args_bytes = _local_bytes(state) + _local_bytes(batch)
            with counter:
                train_step(state, batch)
    elif sc.mode == "prefill":
        tokens = data("tokens", ("batch", "seq"))
        plens = data("prompt_lens", ("batch",))
        enc = data("enc_feats", ("batch", "enc_seq", None)) \
            if "enc_feats" in specs else None
        args_bytes = _local_bytes([params, tokens, plens, enc])
        with use_rules(mesh, rules), counter:
            M.prefill(params, cfg, tokens, plens, sc.seq_len,
                      enc_feats=enc, q_chunk=q_chunk, kv_chunk=kv_chunk)
    else:  # decode
        state = SH.distribute(
            SH.state_shapes(cfg, sc.global_batch, sc.seq_len),
            SH.state_shardings(cfg, mesh, rules, sc.global_batch,
                               sc.seq_len))
        tokens = SH.distribute_leaf(specs["tokens"], SH.replicated(mesh))
        args_bytes = _local_bytes([params, state, tokens])
        with use_rules(mesh, rules), counter:
            M.decode_step(params, cfg, state, tokens, kv_chunk=kv_chunk)
    return cfg, counter, {"zero3": zero3, "strategy": strategy,
                          "mode": sc.mode}, args_bytes


def fake_world(n: int):
    """Rank 0 of a fake world of ``n`` ranks (replacing any fake world
    made before)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def run_one(arch: str, shape_name: str, mesh_kind: str, strategy: str,
            out_dir: str = OUT_DIR, save: bool = True) -> dict:
    from repro_torch.launch.mesh import make_production_mesh
    t0 = time.time()
    n_dev = 512 if mesh_kind == "multi" else 256
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "strategy": strategy, "devices": n_dev}
    try:
        fake_world(n_dev)
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        rec["devices"] = mesh.size()
        cfg, counter, meta, args_bytes = run_combo(arch, shape_name, mesh,
                                                   strategy)
        rec.update(meta)
        rec.update({
            "ok": True,
            "trace_s": round(time.time() - t0, 2),
            "flops": float(counter.flops),
            "collectives": collective_bytes(counter.colls),
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "window": cfg.window,
            "argument_size_in_bytes": int(args_bytes),
        })
    except Exception as e:  # record the failure: these are faults to fix
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
    if save:
        _save(rec, out_dir)
    return rec


def _fname(out_dir, arch, shape, mesh_kind, strategy):
    a = arch.replace(".", "_")
    return os.path.join(out_dir, f"{a}__{shape}__{mesh_kind}__{strategy}.json")


def _save(rec, out_dir) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(_fname(out_dir, rec["arch"], rec["shape"], rec["mesh"],
                     rec["strategy"]), "w") as f:
        json.dump(rec, f, indent=1)


# ---------------------------------------------------------------------------
def iter_combos(mesh_kinds, strategies, archs=None, shapes=None):
    for arch in (archs or ASSIGNED_ARCHS):
        for shape in (shapes or list(SHAPES)):
            if (arch, shape) in SKIPS:
                continue
            for mk in mesh_kinds:
                for st in strategies:
                    yield arch, shape, mk, st


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--strategy", default="fastdecode",
                    choices=["fastdecode", "fastdecode_sm", "baseline",
                             "dp", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=OUT_DIR,
                    help="directory for the records (default "
                         "build/dryrun_torch/)")
    args = ap.parse_args(argv)

    mesh_kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    strategies = (["fastdecode", "baseline"] if args.strategy == "both"
                  else [args.strategy])
    if args.list:
        for c in iter_combos(mesh_kinds, strategies):
            print(*c)
        return
    combos = list(iter_combos(
        mesh_kinds, strategies,
        archs=[args.arch] if args.arch else None,
        shapes=[args.shape] if args.shape else None))
    if not args.all and len(combos) > 8 and not (args.arch or args.shape):
        raise SystemExit("refusing full sweep without --all")
    for arch, shape, mk, st in combos:
        rec = run_one(arch, shape, mk, st, out_dir=args.out)
        status = "OK " if rec.get("ok") else "FAIL"
        extra = (f"flops={rec.get('flops', 0):.3g} "
                 f"coll={rec['collectives']['wire_bytes']:.3g}B "
                 f"args={rec['argument_size_in_bytes']:.3g}B "
                 f"trace={rec['trace_s']}s"
                 if rec.get("ok") else rec.get("error", ""))
        print(f"[{status}] {arch} {shape} {mk} {st}: {extra}", flush=True)


if __name__ == "__main__":
    main()
