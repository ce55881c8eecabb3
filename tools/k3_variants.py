#!/usr/bin/env python3
"""Variants of kernel 3 (csrc/decode_attention.cu) timed in turns on one
NVIDIA GPU.

    python3 tools/k3_variants.py [--out FILE.json]

Each variant is this tree's csrc with a few lines replaced (``VARIANTS``),
written to build/k3_variants/<name>/ and built there with the port's nvcc
flags, one nvcc each, all at once (``tools/variants.py``).  A parent's
csrc is timed against this tree's, and kernel 3's outputs held bitwise to
the parent's, by ``chip_smoke.py``'s compare_dense phase.  The variants:

  decode16        the 8-row decode instances (bf16 q, int8 K/V, Dh 64 and
                  128: the slab and paged entries) on the 16-row engine
                  (Mma16Engine) in place of MmaEngine
  l2pf256         every 16-byte K/V copy with a 256-byte L2 prefetch
  no-kv-copies    the 16-row engine without its K/V copies (its tile loop
                  without their bytes; outputs not checked)
  no-tile-compute the 16-row engine without its per-tile compute (the
                  ring's loads and waits alone; outputs not checked)

The cases: kernel 3's Dh 128 slab decode (Hq 32 / Hkv 8) and paged
decode at the int8 serve's per-worker call (2 x 512 tokens) and at 64 x
4096, its Dh 256 slab entry at recurrentgemma-2b's heads (Hq 10 / Hkv 1;
2 x 1024 slots, 512 valid, and 64 x 2048) and its multi-token entry (T 4,
Hq 32 / Hkv 8; 2 x 512 and 64 x 4096). Every variant but the ablations is
held to the plain version (chip_smoke.py's bf16 tolerance) first, and
l2pf256 (a cache hint) must equal this tree's bit for bit everywhere.
Device ms come from CUDA graph replay (chip_smoke.py's
``graph_time_ms``), each variant timed in one order and then in the
reverse order. Registers from ptxas and CTAs per SM from the CUDA
occupancy calculator (the source's ``repro_decode_attention_occupancy``)
are printed for each build. One JSON object a case on stdout, all of them
in ``--out``.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DA_CU = "decode_attention.cu"

# name -> [(file, a line of the tree's source, its replacement)]
VARIANTS = {
    "decode16": [
        (DA_CU, "    else return pick<TQ, TKV, DH, 8, PAGED, false>();",
         "    else return pick<TQ, TKV, DH, 16, PAGED, false>();")],
    "l2pf256": [
        ("tc_decode.cuh",
         '  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n"',
         '  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, '
         '%2;\\n"')],
    "no-kv-copies": [
        (DA_CU, "      for (int j = 0; j < R::kChunks / TPR; ++j) {",
         "      for (int j = 0; j < R::kChunks / TPR\n"
         "           && !std::is_same<E, Mma16Engine<DH, MULTI>>::value;"
         " ++j) {")],
    "no-tile-compute": [
        (DA_CU, "    const int tok0 = 16 * warp;\n"
         "    // ---- S^T = K q^T on the tensor cores, q's fragments from "
         "shared; two\n",
         "    return;\n"
         "    const int tok0 = 16 * warp;\n"
         "    // ---- S^T = K q^T on the tensor cores, q's fragments from "
         "shared; two\n")]}
ABLATIONS = ("no-kv-copies", "no-tile-compute")


def build_variants():
    """{name: (declared entry points, ptxas rows)} of every variant, the
    tree's own source included as "tree"; a build that fails is reported
    and left out."""
    import chip_smoke as C
    import variants as V
    builds = V.build(ROOT / "build" / "k3_variants", VARIANTS,
                     ("decode_attention",))
    return {name: (b["decode_attention"][0],
                   [r for r in C.ptxas_summary(b["decode_attention"][1])
                    if r.get("engine", "").startswith("tensor cores")
                    and r.get("kv_dtype") == "int8"])
            for name, b in builds.items()}


def cases(dev):
    """[(name, fn(i), the plain version's output, calls a graph)]."""
    import torch
    from repro_torch.kernels import quant_kv as QK
    from repro_torch.kernels import ref
    import chip_smoke as C
    out = []
    for label, kw, copies, (hq, hkv, dh) in (
            ("dh128-slab-main", dict(b=2, s=1024, n_valid=512), 16,
             (32, 8, 128)),
            ("dh128-slab-bw", dict(b=64, s=4096, n_valid=4096), 1,
             (32, 8, 128)),
            ("dh256-main", dict(b=2, s=1024, n_valid=512), 16, (10, 1, 256)),
            ("dh256-bw", dict(b=64, s=2048, n_valid=2048), 1, (10, 1, 256))):
        bufs, pos, lens = C._slab_inputs(dev, hq=hq, hkv=hkv, dh=dh,
                                         copies=copies, **kw)
        r = C._slab_runs(pos, lens)["decode_attention_int8"]
        out.append((label, lambda i, b=bufs, r=r: r["kern"](b[i % len(b)]),
                    r["check"](bufs[0]), copies * max(1, 16 // copies)))
    for label, b, n_tok, t, copies in (("dh128-paged-main", 2, 512, 1, 16),
                                       ("dh128-paged-bw", 64, 4096, 1, 1),
                                       ("verify-main", 2, 512, 4, 16),
                                       ("verify-bw", 64, 4096, 4, 1)):
        bufs, lens = C._verify_int8_inputs(
            dev, b=b, n_tok=n_tok, t=t, hq=32, hkv=8, dh=128, page=16,
            cache_len=1024 if b == 2 else None, copies=copies, deq=False)
        q, kq, ks, vq, vs, tables = bufs[0]
        if t == 1:
            bufs = [(x[0][:, 0].contiguous(), *x[1:]) for x in bufs]
            fn = (lambda i, bb=bufs, ln=lens:
                  QK.paged_decode_attention_int8(*bb[i % len(bb)], ln))
            want = ref.paged_decode_attention_int8_ref(
                q[:, 0].float(), kq, ks, vq, vs, tables, lens)
        else:
            fn = (lambda i, bb=bufs, ln=lens:
                  QK.paged_verify_attention_int8(*bb[i % len(bb)], ln))
            want = ref.paged_verify_attention_int8_ref(
                q.float(), kq, ks, vq, vs, tables, lens)
        out.append((label, fn, want, copies * max(1, 16 // copies)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "k3_variants" / "report.json")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import torch
    if not torch.cuda.is_available():
        print("k3_variants.py: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as C
    from repro_torch.kernels import decode_attention as DA
    dev = torch.device("cuda", 0)
    print(C.gpu_name_and_limit(), flush=True)
    built = build_variants()

    def use(name):
        DA._fns.clear()
        DA._fns.update(built[name][0])

    report = {"gpu": C.gpu_name_and_limit(), "builds": {}, "cases": []}
    for name, (fns, rows) in built.items():
        occ = {}
        if DA._OCCUPANCY in fns:
            use(name)
            # at the main shapes' staged index (slots or pages a split)
            for label, kw in (
                    ("dh128-slab", dict(paged=False, t=1, hq=32, hkv=8,
                                        dh=128, per_split=64)),
                    ("dh128-paged", dict(paged=True, t=1, hq=32, hkv=8,
                                         dh=128, per_split=4)),
                    ("dh256-slab", dict(paged=False, t=1, hq=10, hkv=1,
                                        dh=256, per_split=64)),
                    ("verify-T4", dict(paged=True, t=4, hq=32, hkv=8,
                                       dh=128, per_split=4))):
                occ[label] = DA.occupancy(kv_int8=True, dtype=torch.bfloat16,
                                          **kw)
        report["builds"][name] = {"ptxas": rows, "rows_and_ctas_per_sm": occ}
        print(json.dumps({"build": name, "rows_and_ctas_per_sm": occ,
                          "ptxas": rows}), flush=True)
    order = list(built)
    try:
        for label, fn, want, calls in cases(dev):
            errs, outs = {}, {}
            for name in order:
                use(name)
                if name in ABLATIONS:
                    continue
                outs[name] = fn(0)
                errs[name], ok = C.tol_check(outs[name], want, "bfloat16")
                if not ok:
                    raise AssertionError(f"{name} at {label}: max err "
                                         f"{errs[name]}")
            same = {}
            if "l2pf256" in outs:
                same["l2pf256"] = bool(torch.equal(outs["tree"],
                                                   outs["l2pf256"]))
            if not all(same.values()):
                raise AssertionError(f"{label}: not bitwise this tree's: "
                                     f"{same}")
            dev_ms = {name: [] for name in order}
            for names in (order, order[::-1]):
                for name in names:
                    use(name)
                    dev_ms[name].append(C.graph_time_ms(fn, calls))
            rec = {"case": label, "device_ms": dev_ms, "max_abs_err": errs,
                   "bitwise_equal_to_tree": same}
            report["cases"].append(rec)
            print(json.dumps(rec), flush=True)
    finally:
        use("tree")
        DA._fns.clear()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
