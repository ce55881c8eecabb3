#!/usr/bin/env python3
"""Variants of the tensor-core decode engine for bf16 K/V
(csrc/tc_decode.cuh ``Bf16MmaEngine``: kernel 1 over a page pool, kernel 2
over a dense slab) timed in turns on one NVIDIA GPU.

    python3 tools/k12_variants.py [--out FILE.json]

Each variant is this tree's csrc with a few lines replaced (``VARIANTS``),
written to build/k12_variants/<name>/ and built there with the port's
nvcc flags, both sources of each variant at once (``tools/variants.py``).
A parent's csrc is timed against this tree's by ``chip_smoke.py``'s
compare phases.  The variants:

  stages+1  one more ring stage: 3 of 64 rows at Dh 128 (96 KB, 2 CTAs per
            SM) in place of 2, 4 at Dh 64 (64 KB, 3 per SM) in place of 3
  l2pf256   every 16-byte K/V copy (of kernels 1-4) with the 256-byte L2
            prefetch hint (cp.async ... L2::256B)
  tpr4      4 loader threads per tile row in place of 8: each copy
            instruction of a warp reads a 64-byte piece of 8 rows, not a
            128-byte piece of 4 (kernel 1: half the table lookups)
  k1-g1-fma kernel 1 at G 1 (one query head per kv-head) on the CUDA-core
            FmaEngine, as before the engine
  k2-g1-mma kernel 2 at G 1 on the tensor-core engine in place of the
            CUDA-core FmaEngine

The cases: kernel 1 at one R-worker call of the serve (2 x 512 tokens,
Hq 32 / Hkv 8, Dh 128) and at 64 x 4096, and at the serve call with
llama4-scout's heads (G 5), grok-1's (G 6, softcap 30), llama-13b's and
opt-175b's (G 1), llama-13b's also at 64 x 4096; kernel 2 at the dense
serve's call (2 rows, 1024 slots, 512 valid) and 64 x 4096, and as the
cross-attention R-Part at llama-3.2-vision-90b's heads (G 8, Dh 128, S
1600) and whisper-medium's (G 1, Dh 64, S 1500), 2 rows and 64, whisper's
also on the 1, 3 and 4 rows a worker holds after fleet_xattn's move and
restore.  Every build is held to the plain version (chip_smoke.py's bf16
tolerance); stages+1, l2pf256 and tpr4 change no arithmetic and must
equal this tree's outputs bit for bit.
Device ms come from CUDA graph replay (chip_smoke.py's
``graph_time_ms``), each build timed in one order and then in the
reverse order.  Registers from ptxas and CTAs per SM from the CUDA
occupancy calculator are printed for each build.  One JSON object a case
on stdout, all of them in ``--out``.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HDR = "tc_decode.cuh"

# name -> [(file, a line of the tree's source, its replacement)]
VARIANTS = {
    "stages+1": [
        (HDR, "template <int DH, int STAGES = (DH == 128 ? 2 : 3)>",
         "template <int DH, int STAGES = (DH == 128 ? 3 : 4)>")],
    "l2pf256": [
        (HDR,
         '  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n"',
         '  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, '
         '%2;\\n"')],
    "tpr4": [
        (HDR, "  static constexpr int kLoadTPR = 8;",
         "  static constexpr int kLoadTPR = 4;")],
    "k1-g1-fma": [
        ("paged_attention.cu",
         "    if constexpr (kBf16) {\n"
         "      return pick<T, DH, 8, false, true>();\n",
         "    if constexpr (kBf16) {\n"
         "      if (rows <= 1) return pick<T, DH, 1, false, false>();\n"
         "      return pick<T, DH, 8, false, true>();\n")],
    "k2-g1-mma": [
        ("decode_attention.cu",
         "    if (g == 1) return pick<TQ, TKV, DH, 1, PAGED, false>();\n", "")]}
SAME_ARITHMETIC = ("stages+1", "l2pf256", "tpr4")


def cases(dev):
    """[(name, fn(i), the plain version's output, calls a graph)]."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref
    import chip_smoke as C
    out = []
    for label, kw in (
            ("k1-main", dict(b=2, n_tok=512, cache_len=1024, copies=16)),
            ("k1-bw", dict(b=64, n_tok=4096, copies=1)),
            ("k1-scout-main", dict(b=2, n_tok=512, cache_len=1024, hq=40,
                                   copies=16)),
            ("k1-grok-main", dict(b=2, n_tok=512, cache_len=1024, hq=48,
                                  copies=16, softcap=30.0)),
            ("k1-llama13b-main", dict(b=2, n_tok=512, cache_len=1024, hq=40,
                                      hkv=40, copies=16)),
            ("k1-llama13b-bw", dict(b=64, n_tok=4096, hq=40, hkv=40,
                                    copies=1)),
            ("k1-opt175b-main", dict(b=2, n_tok=512, cache_len=1024, hq=96,
                                     hkv=96, copies=16))):
        cap = kw.pop("softcap", 0.0)
        kw.setdefault("hq", 32)
        kw.setdefault("hkv", 8)
        bufs, _, _ = C._timing_case(dev, dh=128, page=16, t=None,
                                    cache_len=kw.pop("cache_len", None), **kw)
        if cap:
            bufs = [((x[0] * C.SOFTCAP_Q_SCALE["bfloat16"]).to(x[0].dtype),)
                    + tuple(x[1:]) for x in bufs]
        attn = dict(softcap=cap) if cap else {}
        out.append((label, lambda i, bb=bufs, a=attn:
                    PA.paged_decode_attention(*bb[i % len(bb)][:5], **a),
                    ref.paged_decode_attention_ref(*bufs[0][:5], **attn),
                    len(bufs) * max(1, 16 // len(bufs))))
    for label, kw, copies, cross in (
            ("k2-serve-main", dict(b=2, s=1024, n_valid=512, hq=32, hkv=8,
                                   dh=128), 16, False),
            ("k2-serve-bw", dict(b=64, s=4096, n_valid=4096, hq=32, hkv=8,
                                 dh=128), 1, False),
            ("k2-vision-main", dict(b=2, s=1600, n_valid=1600, hq=64, hkv=8,
                                    dh=128), 16, True),
            ("k2-vision-bw", dict(b=64, s=1600, n_valid=1600, hq=64, hkv=8,
                                  dh=128), 1, True),
            ("k2-whisper-main", dict(b=2, s=1500, n_valid=1500, hq=16,
                                     hkv=16, dh=64), 16, True),
            ("k2-whisper-bw", dict(b=64, s=1500, n_valid=1500, hq=16,
                                   hkv=16, dh=64), 1, True)) + tuple(
            (f"k2-whisper-{n}rows", dict(b=n, s=1500, n_valid=1500, hq=16,
                                         hkv=16, dh=64), 16, True)
            for n in (1, 3, 4)):
        bufs, pos, lens = C._slab_inputs(dev, copies=copies, cross=cross,
                                         **kw)
        r = C._slab_runs(pos, lens)["decode_attention"]
        out.append((label, lambda i, b=bufs, r=r: r["kern"](b[i % len(b)]),
                    r["check"](bufs[0]), copies * max(1, 16 // copies)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "k12_variants" / "report.json")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import torch
    if not torch.cuda.is_available():
        print("k12_variants.py: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as C
    import variants as V
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import paged_attention as PA
    dev = torch.device("cuda", 0)
    gpu = C.gpu_name_and_limit()
    print(gpu, flush=True)
    builds = V.build(ROOT / "build" / "k12_variants", VARIANTS,
                     ("decode_attention", "paged_attention"))
    report = {"gpu": gpu, "builds": {}, "cases": []}
    for name, b in builds.items():
        V.use(builds, name)
        rows = [r for stem in b for r in C.ptxas_summary(b[stem][1])
                if r["dtype"] == "bfloat16" and r.get("entry") in
                ("decode", "slab") and r.get("kv_dtype", "bfloat16")
                == "bfloat16"]
        occ = {}
        for label, hq, hkv, dh, per_split in (("k1-G4-dh128", 32, 8, 128, 4),
                                              ("k1-G1-dh128", 40, 40, 128, 4)):
            occ[label] = PA.ctas_per_sm(1, hq, hkv, dh, torch.bfloat16,
                                        per_split)
        for label, hq, hkv, dh, per_split in (("k2-G8-dh128", 64, 8, 128, 95),
                                              ("k2-G1-dh64", 16, 16, 64, 167)):
            occ[label] = DA.occupancy(kv_int8=False, paged=False, t=1, hq=hq,
                                      hkv=hkv, dh=dh, dtype=torch.bfloat16,
                                      per_split=per_split)
        report["builds"][name] = {"ptxas": rows, "ctas_per_sm": occ}
        print(json.dumps({"build": name, "ctas_per_sm": occ, "ptxas": rows}),
              flush=True)
    order = list(builds)
    try:
        for label, fn, want, calls in cases(dev):
            errs, outs = {}, {}
            for name in order:
                V.use(builds, name)
                outs[name] = fn(0)
                errs[name], ok = C.tol_check(outs[name], want, "bfloat16")
                if not ok:
                    raise AssertionError(f"{name} at {label}: max err "
                                         f"{errs[name]}")
            same = {name: bool(torch.equal(outs["tree"], outs[name]))
                    for name in SAME_ARITHMETIC if name in outs}
            if not all(same.values()):
                raise AssertionError(f"{label}: not bitwise this tree's: "
                                     f"{same}")
            dev_ms = {name: [] for name in order}
            for names in (order, order[::-1]):
                for name in names:
                    V.use(builds, name)
                    dev_ms[name].append(C.graph_time_ms(fn, calls))
            rec = {"case": label, "device_ms": dev_ms, "max_abs_err": errs,
                   "bitwise_equal_to_tree": same}
            report["cases"].append(rec)
            print(json.dumps(rec), flush=True)
    finally:
        V.reset()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
