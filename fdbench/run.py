#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` on the CUDA card(s) of
this machine and print its result as the last line of standard output.

    python3 fdbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (a profiler covers a slice of
the window) and the device's busy and window seconds.  Without the cards
the cell asks for, or with the JAX package loaded once the window has
closed, it exits nonzero and prints no result.  Caches of what the run
builds stay inside the checkout, under ``build/``.

The readings that a cell's correctness limits are set from come from the
same runs, one after another in one process, one JSON line each::

    python3 fdbench/run.py --workload <cell> --seeds 1,2,3 --seconds <s> \
        [--control] [--faults token_altered,state_unchanged,half_batch]

``--control`` adds the fp8 control's gap on the same served tokens;
``--faults`` plants the named fault of ``fdbench/lib/faults.py`` under
the timed path of the run of the seed in the same place.  The
benchmark's own runs use neither.
"""
import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WATCHDOG_S = 345.0              # a run ends within 360 s
WATCHDOG_RSS = 48 * 2 ** 30     # host memory: half the one-card machine's
READINGS_WATCHDOG_S = 3300.0


def limit_readings(C, bench, cell, args) -> int:
    """One run of the cell for each seed, each line its readings."""
    import torch

    from fdbench.lib import faults as FL
    seeds = [int(x) for x in args.seeds.split(",")]
    faults = args.faults.split(",") if args.faults else [None] * len(seeds)
    if len(faults) != len(seeds):
        raise SystemExit("--faults names one fault for each seed")
    for seed, fault in zip(seeds, faults):
        t0 = time.perf_counter()
        res = C.run_cell(cell, seed, args.seconds, False, t_proc0=t0,
                         control=args.control,
                         fault=FL.FAULTS[fault] if fault else None)
        line = {"workload": cell.name, "seed": seed, "fault": fault,
                "correct": res["correct"], "readings": res["readings"],
                "counts": res["_counts"],
                "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                "metrics": C.reduce_metrics(bench, res, False),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    seeds = ap.add_mutually_exclusive_group(required=True)
    seeds.add_argument("--seed", type=int)
    seeds.add_argument("--seeds", help="readings: comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    cache = ROOT / "build" / "fdbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from fdbench.lib import cell as C
    from fdbench.lib import guard
    bench = C.load_benchmark()
    cell = C.load_cell(bench, args.workload)
    if args.seeds:
        guard.start(T_PROC0, READINGS_WATCHDOG_S, WATCHDOG_RSS)
        return limit_readings(C, bench, cell, args)
    guard.start(T_PROC0, WATCHDOG_S, WATCHDOG_RSS)
    try:
        res = C.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         t_proc0=T_PROC0)
    except C.NoDevice as e:
        print(f"fdbench: {e}", file=sys.stderr)
        return 2
    banned = C.banned_modules()
    if banned:
        print(f"fdbench: modules of the JAX package loaded: {banned}",
              file=sys.stderr)
        return 3
    res["metrics"] = C.reduce_metrics(bench, res, bool(args.trace))
    counts = res.pop("_counts")
    res.pop("_run")
    readings = res.pop("readings")
    print("fdbench: samples " + json.dumps(counts), file=sys.stderr)
    print("fdbench: readings " + json.dumps(readings), file=sys.stderr)
    checks = res.pop("checks")
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    res["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
