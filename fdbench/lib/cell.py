"""One run of one cell of the benchmark of ``repro_torch``.

The cell's pieces are found by name: its entry in ``BENCHMARK.json``
joins a configuration file (``configs/``), a traffic mix
(``traffic/<name>.json``) and the cell's engine sizing and limits
(``cells/<cell>.json``); each metric is a reader file
(``metrics/<metric>.py``).  A run:

1. checks for the cards the cell asks for, builds the port's kernels,
   draws the weights on the card from the seed and builds the port's
   ``ServingEngine`` (hetero backend, paged bf16 KV, 2 micro-batches, 2
   R-workers, page 16, CUDA graphs, greedy sampling);
2. fills it: the closed loop's rows start in steady state; then warm-up
   steps.  All of that is ``setup_s``, from process start;
3. drives ``step()`` by the mix for ``seconds`` (the window), keeping
   every slot busy and counting each token when the ``step()`` that made
   it returns; with ``trace`` a profiler covers the window's last 20%;
4. reads the device's peak memory over the window, frees the engine,
   and checks the served tokens of a sample of the requests (one from
   each half of each R-Part call's rows) against the plain float32
   reference (``reference/``).
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from fdbench.lib import traffic as TR

FDBENCH = Path(__file__).resolve().parents[1]
ROOT = FDBENCH.parent
BANNED = ("jax", "jaxlib", "flax", "repro")
TRACE_START = 0.8              # the profiled slice: the window's last 20%
WARMUP_STEPS = 6               # steps between the fill and the window


class NoDevice(RuntimeError):
    """The cards the cell asks for are not there."""


@dataclass
class Cell:
    name: str
    config: Dict
    mix: Dict
    sizing: Dict
    chips: int = 1


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(bench: Dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench``, its files read under ``root``."""
    try:
        w = next(w for w in bench["workloads"] if w["name"] == name)
    except StopIteration:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json") from None
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    here = root / "fdbench"
    return Cell(
        name=name,
        config=json.loads((root / entry["file"]).read_text()),
        mix=json.loads((here / "traffic" / f"{w['traffic']}.json")
                       .read_text()),
        sizing=json.loads((here / "cells" / f"{name}.json").read_text()),
        chips=int(w["chips"]))


def metrics_for(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: those without a ``workloads`` key and those that list it."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """``fdbench/metrics/<metric>.py``'s ``read(run)``."""
    return load_file(root / "fdbench" / "metrics" / f"{metric}.py",
                     "fdbench_metric_" + metric.replace(".", "_")).read


def family(cfg: Dict):
    return importlib.import_module(f"fdbench.families.{cfg['family']}")


def reference(cfg: Dict):
    return importlib.import_module(f"fdbench.reference.{cfg['reference']}")


def peaks(kind: str) -> Optional[Dict]:
    return json.loads((FDBENCH / "lib" / "peaks.json").read_text()).get(kind)


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(BANNED))


@dataclass
class RunData:
    """What the readers reduce: the window's stamps and counts."""
    cell: Cell
    sizes: Dict
    setup_s: float = 0.0
    t0: float = 0.0
    t1: float = 0.0
    tokens: int = 0
    steps: int = 0
    step_ts: List[float] = field(default_factory=list)
    records: List = field(default_factory=list)
    hotpath: Dict[str, float] = field(default_factory=dict)
    prefills: List[int] = field(default_factory=list)
    decodes: List[int] = field(default_factory=list)
    slice: Optional[Dict] = None
    peaks: Optional[Dict] = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


class Driver:
    """Keeps every slot of the engine busy with the mix's requests and
    counts what each ``step()`` emits."""

    def __init__(self, eng, cell: Cell, seed: int, vocab: int):
        from repro_torch.serving.request import Request
        if cell.mix.get("loop") != "closed":
            raise ValueError(f"mix {cell.mix.get('name')!r}: only a closed "
                             "loop is driven")
        self._Request = Request
        self.eng, self.cell, self.seed, self.vocab = eng, cell, seed, vocab
        self.stream = TR.Stream(cell.mix, seed)
        self.slots = cell.sizing["slots"]
        self.reqs: Dict[int, object] = {}
        self.seen: Dict[int, int] = {}
        self.slot_of: Dict[int, int] = {}
        self.finish: Dict[int, float] = {}
        self.last: Dict[int, float] = {}
        self.run: Optional[RunData] = None     # set for the window
        self.launch_log: Optional[List] = None

    def _submit(self, spec: TR.Spec) -> None:
        r = self._Request(rid=spec.rid, prompt=TR.prompt_tokens(
            self.seed, spec.rid, spec.prompt_len, self.vocab),
            max_new_tokens=spec.out_len)
        self.eng.submit(r)
        self.reqs[spec.rid] = r
        self.seen[spec.rid] = 0

    def arrivals(self) -> None:
        """One new request for every slot not taken or queued for."""
        busy = len(self.eng.queue) + sum(r is not None
                                         for r in self.eng.slots)
        for _ in range(self.slots - busy):
            self._submit(self.stream.next())

    def step(self):
        eng = self.eng
        n_fin = len(eng.finished)
        rec = eng.step()
        t = time.perf_counter()
        done = eng.finished[n_fin:]
        for r in done:
            self.finish[r.rid] = t
        run = self.run
        resident = [r for r in eng.slots if r is not None]
        for r in resident:
            self.slot_of[r.rid] = r.slot
        for r in resident + done:
            g = len(r.generated)
            k = g - self.seen.get(r.rid, 0)
            if k <= 0:
                continue
            self.seen[r.rid] = g
            self.last[r.rid] = t
            if run is None:
                continue
            admitted = r.start_step == rec.step
            decoded = k == 2 if admitted else True
            run.tokens += k
            if admitted:
                run.prefills.append(r.prompt_len)
            if decoded:
                run.decodes.append(r.prompt_len + g - 1)
            if decoded and self.launch_log is not None:
                self.launch_log[-1].append((r.slot, r.prompt_len + g - 1))
        if run is not None:
            run.step_ts.append(t)
        return rec, t

    def fill(self) -> None:
        """The first rows in steady state, admitted ``fill_group`` at a
        time; then ``WARMUP_STEPS`` steps."""
        sz = self.cell.sizing
        first = self.stream.steady(self.slots)
        g = int(sz.get("fill_group", 4))
        for i in range(0, len(first), g):
            for spec in first[i:i + g]:
                self._submit(spec)
            self.step()
        for _ in range(WARMUP_STEPS):
            self.arrivals()
            self.step()


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _launches(log, eng, layers: int, hq: int, hkv: int, dh: int):
    """(flops, bytes) of every kernel-1 launch of the profiled steps: one
    per (layer, micro-batch, R-worker), over the rows that worker holds."""
    from fdbench.roofline import paged_attn
    het = eng.engine
    mb_size = het.mb_size
    out = []
    for step in log:
        per: Dict = {}
        for row, ctx in step:
            mb, local = divmod(row, mb_size)
            wid = next(i for i, (lo, hi) in enumerate(het.slices)
                       if lo <= local < hi)
            per.setdefault((mb, wid), []).append(ctx)
        for mb in range(het.num_mb):
            for wid, (lo, hi) in enumerate(het.slices):
                fb = paged_attn.launch(hq, hkv, dh, per.get((mb, wid), []),
                                       hi - lo)
                out.extend([fb] * layers)
    return out


def build_engine(cell: Cell, seed: int, device: str = "cuda"):
    """(device, weights, the port's engine, its driver) of a cell: the
    kernels built (on a card), the weights drawn from the seed."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        from repro_torch.kernels import build
        build.build()
    cfg = cell.config
    fam = family(cfg)
    params = fam.make_weights(cfg, seed, dev)
    from repro_torch.serving.engine import ServingEngine
    sz = cell.sizing
    eng = ServingEngine(params, fam.program_config(cfg), batch=sz["slots"],
                        cache_len=sz["cache_len"], backend="hetero",
                        paged_kv=True, num_microbatches=2, num_r_workers=2,
                        page_size=16, seed=seed, device=dev)
    return dev, params, eng, Driver(eng, cell, seed, fam.sizes(cfg)["vocab"])


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             t_proc0: float, device: str = "cuda", check_device: bool = True,
             control: bool = False, fault=None) -> Dict:
    """One run; returns the result object (``correct``, ``attempted``,
    ``failed``, ``metrics`` reduced later, ``device``, ...) with the raw
    ``RunData`` under ``"_run"``."""
    import torch
    if check_device and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.chips):
        raise NoDevice(
            f"cell {cell.name} needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}")
    dev, params, eng, drv = build_engine(cell, seed, device)
    cfg, sz, sizes = cell.config, cell.sizing, family(cell.config).sizes(
        cell.config)
    run = RunData(cell=cell, sizes=sizes,
                  peaks=peaks(torch.cuda.get_device_name(dev))
                  if dev.type == "cuda" else None)
    undo = fault(eng) if fault is not None else None
    try:
        if trace:
            # the profiler's first start loads and sets up its tracer for
            # seconds: pay that in set-up, not in the window
            _start_profile(dev).__exit__(None, None, None)
        drv.fill()
        _sync(dev)
        gc.collect()
        gc.freeze()
        if dev.type == "cuda":
            # the peak of the window: not the engine's set-up transients
            torch.cuda.reset_peak_memory_stats(dev)
        hot0 = dict(eng.hotpath_stats())
        run.t0 = time.perf_counter()
        run.setup_s = run.t0 - t_proc0
        drv.run = run
        prof, sl = None, None
        lo_t = run.t0 + TRACE_START * seconds
        n_rec0 = len(eng.records)
        while True:
            now = time.perf_counter()
            if now - run.t0 >= seconds:
                break
            if trace and prof is None and now >= lo_t:
                prof, sl = _start_profile(dev), {"t0": None}
                _sync(dev)
                sl["t0"] = time.perf_counter()
                drv.launch_log = []
            drv.arrivals()
            if drv.launch_log is not None:
                drv.launch_log.append([])
            _, run.t1 = drv.step()
        drv.run = None
        run.steps = len(eng.records) - n_rec0
        run.records = eng.records[n_rec0:]
        hot1 = dict(eng.hotpath_stats())
        run.hotpath = {k: hot1.get(k, 0.0) - hot0.get(k, 0.0) for k in hot1}
        resident = sum(r.prompt_len + len(r.generated)
                       for r in eng.slots if r is not None)
        gc.unfreeze()
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        if prof is not None:
            # the slice ends with the window; stopping the profiler, which
            # gathers its trace for seconds, waits until the window closed
            _sync(dev)
            sl["t1"] = time.perf_counter()
            prof.__exit__(None, None, None)
            sl["log"], drv.launch_log = drv.launch_log, None
            run.slice = _reduce_profile(prof, sl, eng, sizes)
        attempted = sum(1 for t in drv.last.values() if t >= run.t0)
        ranges = row_ranges(eng)
    finally:
        if undo is not None:
            undo()
        eng.close()
    sample = _sample(drv, run, seed, ranges)
    wrong = sum(1 for r in drv.reqs.values()
                if drv.finish.get(r.rid, -1.0) >= run.t0
                and len(r.generated) != r.max_new_tokens)
    drv.eng = None
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_chk = time.perf_counter()
    checks = _check(params, cfg, sample, dev, control)
    t_chk = time.perf_counter() - t_chk
    checks["wrong_lengths"] = float(wrong)
    limits = sz["check"]["limits"]
    compared = {k: {"value": v, "limit": limits[k]}
                for k, v in checks.items() if k in limits}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(wrong),
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": cell.chips,
                      "memory_peak_bytes": int(peak)},
           "checks": compared, "readings": checks, "_run": run,
           "_counts": {"tokens": run.tokens, "steps": run.steps,
                       "admit_steps": sum(1 for r in run.records
                                          if r.admitted),
                       "admitted": sum(r.admitted for r in run.records),
                       "steps_per_s_fifths": _fifths(run),
                       "pool_fill_pct": 100.0 * resident
                       / (sz["slots"] * sz["cache_len"]),
                       "requests_checked": len(sample),
                       "tokens_checked": sum(len(r.generated)
                                             for r in sample),
                       "check_s": t_chk}}
    if run.slice is not None:
        out["device"]["busy_s"] = run.slice["busy_s"]
        out["device"]["window_s"] = run.slice["wall_s"]
        out["breakdown"] = {"device_ops": run.slice["device_ops"],
                            "idle_gaps": run.slice["idle_gaps"]}
    return out


def _start_profile(dev):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _reduce_profile(prof, sl: Dict, eng, sizes: Dict) -> Dict:
    from fdbench.lib import profile as P
    events = prof.events()
    starts = [e.time_range.start for e in events]
    t0_us = min(starts) if starts else 0.0
    wall = sl["t1"] - sl["t0"]
    red = P.reduce(prof, t0_us, t0_us + wall * 1e6)
    red["wall_s"] = wall
    red["steps"] = len(sl["log"])
    red["launches"] = _launches(sl["log"], eng, sizes["layers"],
                                sizes["hq"], sizes["hkv"], sizes["dh"])
    return red


def row_ranges(eng) -> List[range]:
    """The engine's slots in the row ranges that one R-Part call's first
    and second half cover: for each micro-batch and R-worker, the first
    ceil(n / 2) and the last floor(n / 2) of the worker's n rows."""
    het = eng.engine
    out = []
    for mb in range(het.num_mb):
        base = mb * het.mb_size
        for lo, hi in het.slices:
            mid = lo + (hi - lo + 1) // 2
            out += [range(base + a, base + b)
                    for a, b in ((lo, mid), (mid, hi)) if b > a]
    return out


def _sample(drv: Driver, run: RunData, seed: int, ranges: List[range]
            ) -> List:
    """The requests whose served tokens are checked: the one with most
    served tokens of those finished in the window, and from each row range
    of ``ranges`` one request drawn from the seed among those finished in
    the window on its rows, or where none finished there, the one still
    running there with most served tokens."""
    done = sorted((r for r in drv.reqs.values()
                   if drv.finish.get(r.rid, -1.0) >= run.t0),
                  key=lambda r: r.rid)
    running = sorted((r for r in drv.reqs.values()
                      if r.rid not in drv.finish and r.generated),
                     key=lambda r: (-len(r.generated), r.rid))
    rng = np.random.default_rng([int(seed), 0xC4EC])
    out = [max(done, key=lambda r: len(r.generated))] if done else []
    for rows in ranges:
        mine = [r for r in done if drv.slot_of.get(r.rid) in rows]
        if mine:
            pick = mine[int(rng.integers(len(mine)))]
        else:
            pick = next((r for r in running
                         if drv.slot_of.get(r.rid) in rows), None)
        if pick is not None and all(pick is not x for x in out):
            out.append(pick)
    return out


def _fifths(run: RunData) -> List[float]:
    """Steps a second in each fifth of the window: a rate that drifts
    within a run shows here."""
    ts = np.asarray(run.step_ts)
    edges = run.t0 + run.window_s * np.arange(6) / 5
    counts = np.histogram(ts, bins=edges)[0] if ts.size else np.zeros(5)
    return [float(c) / (run.window_s / 5) for c in counts]


def _check(params, cfg: Dict, sample: List, dev, control: bool
           ) -> Dict[str, float]:
    """The widest gap by which a served token's logit lies below the
    reference's best at its position, over every served token of the
    sample; with ``control`` also the same gap of the token the fp8
    control puts first at each of those positions."""
    import torch
    ref = reference(cfg)
    seqs, starts, toks = [], [], []
    for r in sample:
        full = np.concatenate([np.asarray(r.prompt, np.int64),
                               np.asarray(r.generated[:-1], np.int64)])
        seqs.append(torch.from_numpy(full).to(dev))
        starts.append(r.prompt_len - 1)
        toks.append(torch.tensor(r.generated, dtype=torch.long, device=dev))
    out = {"max_gap": float("inf") if not sample else 0.0}
    if not sample:
        return out
    lg = ref.logits(params, cfg, seqs, starts)
    best = [x.max(dim=-1).values for x in lg]
    gap = max(float((b - x.gather(1, t[:, None])[:, 0]).max())
              for b, x, t in zip(best, lg, toks))
    out["max_gap"] = gap
    if control:
        cl = ref.logits(params, cfg, seqs, starts, quant="fp8")
        out["control_max_gap"] = max(
            float((b - x.gather(1, c.argmax(-1)[:, None])[:, 0]).max())
            for b, x, c in zip(best, lg, cl))
    return out


def reduce_metrics(bench: Dict, res: Dict, trace: bool,
                   root: Path = ROOT) -> Dict:
    """The cell's metrics, each from its reader; a reader that finds
    nothing to read returns None and the metric is left out."""
    run = res["_run"]
    out = {}
    for m in metrics_for(bench, run.cell.name, trace):
        v = reader(m["name"], root)(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
