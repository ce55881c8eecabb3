#!/usr/bin/env python3
"""Whether kernels 1, 2 and 4 (csrc/paged_attention.cu and
csrc/decode_attention.cu) give the same bits whatever their shared memory
held before and however their warps are timed, on one NVIDIA GPU.

    python3 tools/k12_determinism.py [--repeats N] [--out FILE.json]

Three builds (``tools/variants.py``) of the same arithmetic:

  tree    this tree's sources
  poison  every word of each kernel's shared memory (the dynamic ring, the
          staged table or slot bits after it, the engine's static state)
          set to 0xFFFFFFFF (NaN in fp32 and in bf16) at the kernel's
          start: a read of shared memory that nothing wrote changes the
          output
  jitter  each warp sleeps a warp-, tile- and CTA-dependent time before it
          loads a tile, before it computes one and before the warps'
          merge: a missing barrier lets a warp read a stage or a state
          that is not yet (or no longer) its own, and changes the output

Each build runs ``chip_smoke.py``'s kernel_checks (kernel 1, bf16 and
fp32), verify_checks (kernel 4), slab_checks and cross_checks (kernel 2)
with every check as in the kernel phase and every output of the kernels'
wrappers recorded; each variant's outputs must equal the tree's bit for
bit.  The tree's bf16 outputs held to the engine's model are reported per
case: the largest error, the smallest margin under ``MODEL_TOL``, and the
smallest distance between the model and an fp32 value that rounds to the
kernel's bf16 output (how far the kernel's fp32 result at least was from
the model).  Then kernel_checks' first bf16 case (G 1, page 4) and the
vision cross call (G 8, 2 rows of 1600 slots) run ``--repeats`` times on
the tree, each output bitwise the first.  The host's CPU and torch's CPU
capability are printed (the models run on the host).  One JSON object a
step on stdout, all of them in ``--out``.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PA_CU, DA_CU = "paged_attention.cu", "decode_attention.cu"

POISON = """
  {
    unsigned n_dyn;
    asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(n_dyn));
    for (unsigned i = threadIdx.x; i < n_dyn / 4; i += kThreads)
      reinterpret_cast<unsigned*>(ring)[i] = 0xFFFFFFFFu;
    unsigned* st = reinterpret_cast<unsigned*>(&sh);
    for (unsigned i = threadIdx.x; i < sizeof(sh) / 4; i += kThreads)
      st[i] = 0xFFFFFFFFu;
    __syncthreads();
  }"""


def _sleep(a, b, c):
    return (f"    __nanosleep(((threadIdx.x / 32) * {a} + k * {b} "
            f"+ blockIdx.x * {c}) % 512);\n")


def variants():
    """name -> [(file, a line of the tree's source, its replacement)]."""
    out = {"poison": [], "jitter": []}
    for cu, table in ((PA_CU, "s_tbl"), (DA_CU, "s_idx")):
        line = f"  int* {table} = reinterpret_cast<int*>(ring + R::kBytes);"
        out["poison"].append((cu, line, line + POISON))
        load = "    const int stage = k % R::kStages;\n"
        tile = "    eng.tile(p, ring, k % R::kStages);\n"
        fin = "  eng.finish(p, ring, split, b, h, r0, nr);\n"
        out["jitter"] += [
            (cu, load, load + _sleep(53, 17, 7)),
            (cu, tile, _sleep(97, 31, 13) + tile),
            (cu, fin, "  __nanosleep(((threadIdx.x / 32) * 211) % 512);\n"
             + fin)]
    return out


def _half_ulp(g, x):
    """Half the bf16 spacing at each element of ``g`` (bf16 values in
    fp32) on the side of ``x``."""
    import torch
    a = g.abs()
    e = torch.floor(torch.log2(a.clamp(min=2.0 ** -126)))
    ulp = torch.exp2(e - 7)
    down = (x.abs() < a) | (torch.sign(x) != torch.sign(g))
    ulp = torch.where(down & (a == torch.exp2(e)), ulp / 2, ulp)
    return torch.where(a > 0, ulp / 2, torch.zeros_like(ulp))


def model_stats(name, got, model) -> dict:
    import chip_smoke as C
    atol, rtol = C.MODEL_TOL
    g = got.float().cpu()
    d = (g - model).abs()
    margin = atol + rtol * model.abs() - d
    implied = (d - _half_ulp(g, model)).clamp(min=0)
    return {"case": name, "max_abs_err": float(d.max()),
            "min_margin": float(margin.min()),
            "elements_over": int((margin < 0).sum()),
            "min_fp32_distance_max": float(implied.max())}


def run_checks(dev, stats):
    """Every output of the kernels' wrappers while chip_smoke's checks of
    kernels 1, 2 and 4 run, in call order; the model checks recorded in
    ``stats`` (a list) instead of raised."""
    import chip_smoke as C
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import paged_attention as PA
    outs = []
    saved = {}
    for mod, name in ((PA, "paged_decode_attention"),
                      (PA, "paged_verify_attention"),
                      (DA, "decode_attention")):
        f = getattr(mod, name)
        saved[(mod, name)] = f

        def rec(*a, _f=f, _n=name, **k):
            out = _f(*a, **k)
            outs.append((_n, out.detach().cpu()))
            return out
        setattr(mod, name, rec)
    check = C._model_check

    def record(name, got, model, engine):
        stats.append(model_stats(name, got, model))
        return {}
    C._model_check = record
    try:
        for fn in (C.kernel_checks, C.verify_checks, C.slab_checks,
                   C.cross_checks):
            fn(dev)
    finally:
        C._model_check = check
        for (mod, name), f in saved.items():
            setattr(mod, name, f)
    return outs


def repeats(dev, n) -> list:
    import torch
    import chip_smoke as C
    from repro_torch.kernels import paged_attention as PA
    gen = torch.Generator().manual_seed(0)
    q, pk, pv, tables, lens = C._paged_case(
        gen, dtype=torch.bfloat16, dev=dev, b=5, hq=8, hkv=8, dh=128,
        page=4, mp=20, lengths=[37, 5, 0, 63, 20], unmapped_row=2,
        hole=(3, 1), share=(0, 4))
    h = C.CROSS_HEADS["vision"]
    bufs, pos, lens2 = C._slab_inputs(dev, b=2, s=h["s"], n_valid=h["s"],
                                      hq=h["hq"], hkv=h["hkv"], dh=h["dh"],
                                      copies=1, cross=True)
    k2 = C._slab_runs(pos, lens2)["decode_attention"]["kern"]
    res = []
    for label, fn in (("k1-bf16-G1-page4",
                       lambda: PA.paged_decode_attention(q, pk, pv, tables,
                                                         lens)),
                      ("k2-vision-G8-2rows", lambda: k2(bufs[0]))):
        first = fn().clone()
        diff = 0
        for _ in range(n):
            diff += not torch.equal(fn(), first)
        torch.cuda.synchronize()
        res.append({"case": label, "repeats": n, "not_bitwise": diff})
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=2000)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "k12_determinism" / "report.json")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import torch
    if not torch.cuda.is_available():
        print("k12_determinism.py: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as C
    import variants as V
    dev = torch.device("cuda", 0)
    report = {"gpu": C.gpu_name_and_limit(), "host": C.host_cpu()}
    print(json.dumps(report), flush=True)
    builds = V.build(ROOT / "build" / "k12_determinism", variants(),
                     ("decode_attention", "paged_attention"))
    if set(builds) != {"tree", "poison", "jitter"}:
        raise SystemExit(f"builds: {sorted(builds)}")
    outs, ok = {}, True
    try:
        for name in builds:
            V.use(builds, name)
            stats = []
            outs[name] = run_checks(dev, stats)
            if name == "tree":
                report["model"] = stats
                for s in stats:
                    print(json.dumps(s), flush=True)
            else:
                same = (len(outs[name]) == len(outs["tree"])
                        and all(a[0] == b[0] and torch.equal(a[1], b[1])
                                for a, b in zip(outs[name], outs["tree"])))
                report[name] = {"outputs": len(outs[name]),
                                "bitwise_equal_to_tree": same}
                ok = ok and same
                print(json.dumps({"build": name, **report[name]}), flush=True)
        V.use(builds, "tree")
        report["repeats"] = repeats(dev, args.repeats)
        for r in report["repeats"]:
            print(json.dumps(r), flush=True)
            ok = ok and r["not_bitwise"] == 0
    finally:
        V.reset()
    report["ok"] = ok
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
