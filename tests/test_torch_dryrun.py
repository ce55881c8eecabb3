"""The port's multi-pod dry-run (``python -m repro_torch.launch.dryrun``):
twins of ``tests/test_dryrun.py`` and ``test_launchers.py::test_dryrun_list``.
Each combination runs as rank 0 of a fake world of 256 or 512 ranks on
meta DTensors, in a subprocess, writing its record under ``tmp_path``."""
import json
import os
import subprocess
import sys

import pytest

from repro.core.config import ASSIGNED_ARCHS as REF_ARCHS
from repro.core.config import SHAPES as REF_SHAPES
from repro.core.config import SKIPS as REF_SKIPS
from repro_torch.core.config import ASSIGNED_ARCHS, SHAPES, SKIPS, get_arch
from repro_torch.launch.dryrun import input_specs, variant_for_shape

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")


def _run(args, timeout=600, code=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["OMP_NUM_THREADS"] = "2"
    cmd = [sys.executable] + (["-c", code] if code else
                              ["-m", "repro_torch.launch.dryrun"]) + args
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=ROOT)


def _record(out, arch, shape, mesh, strategy):
    with open(os.path.join(out, f"{arch}__{shape}__{mesh}__{strategy}.json")
              ) as f:
        return json.load(f)


def test_dryrun_single_pod_fastdecode(tmp_path):
    p = _run(["--arch", "granite-3-8b", "--shape", "decode_32k",
              "--mesh", "single", "--strategy", "fastdecode",
              "--out", str(tmp_path)])
    assert "[OK ]" in p.stdout, p.stdout + p.stderr
    rec = _record(tmp_path, "granite-3-8b", "decode_32k", "single",
                  "fastdecode")
    assert rec["ok"] and rec["devices"] == 256
    assert rec["flops"] > 0
    assert rec["collectives"]["wire_bytes"] > 0
    # the headline: activation-sized collectives (<100 MB/step vs GB)
    assert rec["collectives"]["wire_bytes"] < 100e6
    assert rec["argument_size_in_bytes"] > 0
    assert rec["params"] == get_arch("granite-3-8b").param_count()
    assert "bytes_accessed" not in rec and "temp_size_in_bytes" not in rec


def test_dryrun_multi_pod(tmp_path):
    p = _run(["--arch", "recurrentgemma-2b", "--shape", "decode_32k",
              "--mesh", "multi", "--strategy", "fastdecode",
              "--out", str(tmp_path)])
    assert "[OK ]" in p.stdout, p.stdout + p.stderr
    rec = _record(tmp_path, "recurrentgemma-2b", "decode_32k", "multi",
                  "fastdecode")
    assert rec["ok"] and rec["devices"] == 512


def test_dryrun_list():
    p = _run(["--list", "--mesh", "both", "--strategy", "both"])
    assert p.returncode == 0, p.stderr
    lines = [ln for ln in p.stdout.splitlines() if ln.strip()]
    # 39 pairs x 2 meshes x 2 strategies
    assert len(lines) == 39 * 4
    assert len(set(lines)) == len(lines)


def test_combos_equal_the_reference():
    assert ASSIGNED_ARCHS == REF_ARCHS
    assert SKIPS.keys() == REF_SKIPS.keys()
    assert {k: (v.seq_len, v.global_batch, v.mode)
            for k, v in SHAPES.items()} == \
        {k: (v.seq_len, v.global_batch, v.mode)
         for k, v in REF_SHAPES.items()}


def test_input_specs_cover_all_modes():
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES:
            if (arch, shape) in SKIPS:
                continue
            cfg = variant_for_shape(get_arch(arch), shape)
            specs = input_specs(cfg, shape)
            assert "tokens" in specs
            assert all(t.device.type == "meta" for t in specs.values())
            if shape == "long_500k":
                # sub-quadratic requirement: window, ssm or local attention
                assert (cfg.window > 0) or ("attn" not in cfg.pattern)


ACCOUNTING = r"""
import torch, torch.distributed as dist
from torch.distributed import _functional_collectives as funcol
from repro_torch.launch.dryrun import _counter_class, collective_bytes, fake_world
fake_world(2)
g = dist.group.WORLD
c = _counter_class()()
with c:
    funcol.all_gather_tensor(torch.empty(4, 128, dtype=torch.bfloat16,
                                         device="meta"), 0, g)
    funcol.all_reduce(torch.empty(16, device="meta"), "sum", g)
    funcol.all_to_all_single(torch.empty(8, device="meta"), [4, 4], [4, 4], g)
    funcol.permute_tensor(torch.empty(4, dtype=torch.int32, device="meta"),
                          [1, 0], g)
    torch.empty(8, 16, device="meta") @ torch.empty(16, 4, device="meta")
got = collective_bytes(c.colls)
assert got["counts"]["all-gather"] == 1
assert got["bytes_by_op"]["all-gather"] == 8 * 128 * 2
assert got["bytes_by_op"]["all-reduce"] == 64
assert got["bytes_by_op"]["all-to-all"] == 32
assert got["bytes_by_op"]["collective-permute"] == 16
assert got["wire_bytes"] == 2048 + 2 * 64 + 32 + 16, got
assert c.flops == 2 * 8 * 16 * 4, c.flops
print("ACCOUNTING_OK")
"""


def test_collective_accounting():
    """The reference parser test's collectives, issued on a fake world:
    bf16[8,128] all-gather, f32[16] all-reduce, an all-to-all of 32 bytes
    and a 16-byte permute (an all-to-all to one peer); and a matmul's
    flops."""
    p = _run([], code=ACCOUNTING, timeout=120)
    assert "ACCOUNTING_OK" in p.stdout, p.stdout + p.stderr


@pytest.mark.parametrize("arch,mode_shape", [
    ("granite-3-8b", "train_4k"), ("granite-3-8b", "prefill_32k"),
    # 56 heads on a model axis of 16: the o projection's input is moved
    # explicitly, or the backward's view of its grad fails
    ("deepseek-coder-33b", "train_4k")])
def test_non_decode_modes_run_reduced(arch, mode_shape):
    """The train step (with its backward, remat and grad_shardings) and
    prefill on the fake 256-rank world, at a depth of one layer and a
    reduced sequence so that the test stays light; the full-depth sweep
    is ``--all``."""
    code = f"""
import dataclasses
import repro_torch.launch.dryrun as DR
from repro_torch.core import config as C
base = C.get_arch
DR.get_arch = lambda n: dataclasses.replace(base(n), num_layers=1)
DR.SHAPES = dict(C.SHAPES)
sc = DR.SHAPES[{mode_shape!r}]
DR.SHAPES[{mode_shape!r}] = dataclasses.replace(sc, seq_len=256)
rec = DR.run_one({arch!r}, {mode_shape!r}, "single", "fastdecode",
                 save=False)
assert rec["ok"], rec.get("traceback")
assert rec["flops"] > 0 and rec["collectives"]["wire_bytes"] > 0
print("MODE_OK", rec["mode"])
"""
    p = _run([], code=code, timeout=300)
    assert "MODE_OK" in p.stdout, p.stdout + p.stderr[-3000:]


def test_long_context_moe_baseline_decode(tmp_path):
    """grok-1 at full depth, long_500k under baseline: DTensor checks two
    uses of one gather mask with ``aten.equal``, which meta tensors
    cannot run; the counter answers it from the shapes."""
    p = _run(["--arch", "grok-1-314b", "--shape", "long_500k",
              "--mesh", "single", "--strategy", "baseline",
              "--out", str(tmp_path)])
    assert "[OK ]" in p.stdout, p.stdout + p.stderr
    rec = _record(tmp_path, "grok-1-314b", "long_500k", "single", "baseline")
    assert rec["ok"] and rec["zero3"] and rec["window"] == 8192
