"""Thread-safe, low-overhead metrics primitives.

One :class:`MetricsRegistry` per engine owns every counter, gauge and
histogram the serving stack publishes.  R-worker threads publish
concurrently with the S-worker driver thread (the CompletionSink hot
path), so every mutation takes the registry's single lock — updates are
sub-microsecond (a float add or a bucket increment), so one lock beats
per-metric locks on both overhead and simplicity.

Histograms are log-bucketed (base-2 octaves split into
``SUBBUCKETS`` geometric sub-buckets): ``observe`` is O(1) via
``math.frexp``, memory is a few hundred ints regardless of sample
count, and ``percentile`` answers p50/p90/p99 to within one sub-bucket
(~19% worst case) — the resolution serving latency dashboards need at
a fraction of the cost of reservoir sampling.

Key naming follows ``repro_torch.obs.schema``: unit suffixes ``_s`` /
``_bytes`` / ``_tokens`` / ``_pages`` / ``_count`` / ``_rate`` /
``_ratio``, with histogram statistic suffixes (``_p50`` ...) appended
after the unit.

The port's copy of repro.obs.registry; the registry's lock is a plain
``threading.Lock`` (the reference builds it with its lock witness's
``make_lock``, which the port does not import).
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Union



class Counter:
    """Monotonically increasing value (events, tokens, bytes)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self.value = 0.0
        self._lock = lock

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v


class Gauge:
    """Last-write-wins instantaneous value (queue depth, resident KV)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self.value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


# histogram bucket geometry: values spanning [2^EXP_LO, 2^EXP_HI), each
# octave split into SUBBUCKETS geometric sub-buckets.  Covers ~30ns to
# ~17min when observing seconds — under/overflows clamp to the edge
# buckets (min/max stay exact regardless).
_EXP_LO = -25
_EXP_HI = 10
_SUBBUCKETS = 4
_NBUCKETS = (_EXP_HI - _EXP_LO) * _SUBBUCKETS
_SUB_GROWTH = 2.0 ** (1.0 / _SUBBUCKETS)


def _bucket_of(v: float) -> int:
    m, e = math.frexp(v)                     # v = m * 2**e, m in [0.5, 1)
    sub = int((m - 0.5) * 2 * _SUBBUCKETS)   # 0 .. SUBBUCKETS-1
    idx = (e - 1 - _EXP_LO) * _SUBBUCKETS + sub
    return min(max(idx, 0), _NBUCKETS - 1)


def _bucket_mid(idx: int) -> float:
    """Geometric midpoint of bucket ``idx`` — the value a percentile
    query reports for samples that landed in it."""
    lo = 2.0 ** (_EXP_LO + idx / _SUBBUCKETS)
    return lo * math.sqrt(_SUB_GROWTH)


class Histogram:
    """Log-bucketed latency/size distribution with p50/p90/p99."""

    __slots__ = ("name", "buckets", "count", "total", "vmin", "vmax",
                 "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self.buckets: List[int] = [0] * _NBUCKETS
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._lock = lock

    def observe(self, v: float) -> None:
        if v < 0.0:
            v = 0.0
        with self._lock:
            self.buckets[_bucket_of(v) if v > 0.0 else 0] += 1
            self.count += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v

    def percentile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1] (bucket-midpoint
        resolution); 0.0 when empty.  Clamped to the exact observed
        min/max so tails never report outside the sample range."""
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = q * self.count
            seen = 0
            for i, n in enumerate(self.buckets):
                seen += n
                if seen >= rank and n:
                    return float(min(max(_bucket_mid(i), self.vmin),
                                     self.vmax))
            return float(self.vmax)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, float]:
        """``{name}_count`` plus ``{name}_{mean,p50,p90,p99,max}`` —
        the unit suffix lives in ``name`` (e.g. ``ttft_s_p50``)."""
        out = {f"{self.name}_count": float(self.count)}
        for stat, v in (("mean", self.mean),
                        ("p50", self.percentile(0.50)),
                        ("p90", self.percentile(0.90)),
                        ("p99", self.percentile(0.99)),
                        ("max", self.vmax if self.count else 0.0)):
            out[f"{self.name}_{stat}"] = float(v)
        return out


class MetricsRegistry:
    """The one namespace every stats surface publishes into.

    ``counter`` / ``gauge`` / ``histogram`` get-or-create by name (a
    name re-requested as a different type raises — one key, one
    meaning).  ``snapshot()`` flattens everything into a plain
    ``{key: float}`` dict following the schema conventions."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, self._lock)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            metrics = list(self._metrics.values())
        out: Dict[str, float] = {}
        for m in metrics:
            if isinstance(m, Histogram):
                out.update(m.snapshot())
            else:
                out[m.name] = float(m.value)
        return out
