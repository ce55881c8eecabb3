"""The one documented stats-key schema, plus the legacy compat shim
(the port's copy of repro.obs.schema).

Convention
----------
Every emitted metrics key is ``snake_case`` and ends in a **unit
suffix**:

========== ======================================================
``_s``      wall-clock seconds (``dispatch_s``, ``ttft_s``)
``_bytes``  bytes (``swap_out_bytes``, ``host_tier_bytes``)
``_tokens`` token counts (``cached_tokens``, ``generated_tokens``)
``_pages``  KV page counts (``shared_pages``, ``swapped_pages``)
``_count``  dimensionless event/object counts (``hits_count``)
``_rate``   per-second rates (``tokens_per_s`` is the one blessed
            irregular spelling, kept for perfmodel symmetry)
``_ratio``  dimensionless ratios/fractions (``token_hit_rate`` is
            the blessed irregular spelling; new keys use ``_ratio``)
========== ======================================================

Histogram keys append a **statistic suffix** *after* the unit:
``_p50`` / ``_p90`` / ``_p99`` / ``_mean`` / ``_max`` / ``_min`` —
so ``ttft_s_p99`` parses as (metric ``ttft``, unit ``_s``, stat
``_p99``).  Drift-report keys use ``_predicted`` / ``_measured`` /
``_rel`` the same way (``drift_dispatch_s_measured``).  Namespace
prefixes (``hotpath_``, ``prefix_``, ``tier_``, ``fleet_``,
``drift_``) go in front and never affect validity.

``check_key`` enforces this; ``tests/test_torch_obs.py`` asserts every
key the port's engine emits conforms.

Compat
------
Renaming live keys would break downstream dashboards, so the legacy
surfaces (``hotpath_stats()`` etc.) return a :class:`StatsDict`: keys
are canonical, but the pre-schema spellings (``hits``, ``restored``,
``bytes_out`` ...) still resolve through ``[]``/``get``/``in``.
"""
from __future__ import annotations

from typing import Dict, Optional

STAT_SUFFIXES = ("_p50", "_p90", "_p99", "_mean", "_max", "_min",
                 "_predicted", "_measured", "_rel")
UNIT_SUFFIXES = ("_s", "_bytes", "_tokens", "_pages", "_count",
                 "_rate", "_ratio")
# grandfathered spellings that predate the schema and read better than
# their mechanical normalization would
BLESSED = ("_per_s", "_hit_rate")


def check_key(key: str) -> bool:
    """True iff ``key`` follows the naming convention."""
    for s in STAT_SUFFIXES:
        if key.endswith(s):
            key = key[: -len(s)]
            break
    return key.endswith(UNIT_SUFFIXES) or key.endswith(BLESSED)


def assert_conforms(keys) -> None:
    bad = sorted(k for k in keys if not check_key(k))
    if bad:
        raise AssertionError(
            f"{len(bad)} stats key(s) violate the unit-suffix schema "
            f"(see repro_torch/obs/schema.py): {bad}")


# legacy spelling -> canonical key, one flat namespace (legacy names
# never collided across surfaces, so one table serves them all)
LEGACY_ALIASES: Dict[str, str] = {
    # hotpath_stats() / engine.step_stats
    "steps": "steps_count",
    "ooo_advances": "ooo_advances_count",
    # prefix_cache_stats()
    "hits": "hits_count",
    "misses": "misses_count",
    # tiering_stats() (HostTier.stats spellings)
    "swapped_out": "swap_out_count",
    "restored": "restore_count",
    "spilled": "spill_count",
    "dropped": "drop_count",
    "bytes_out": "swap_out_bytes",
    "bytes_in": "swap_in_bytes",
    "sim_seconds": "sim_stream_s",
    "host_bytes": "host_tier_bytes",
    "preemptions": "preemptions_count",
    "put_failed": "put_failed_count",
    "get_failed": "get_failed_count",
    "corrupt": "corrupt_count",
    # FleetTelemetry.summary()
    "migrations": "migrations_count",
    "failures": "failures_count",
    "recoveries": "recoveries_count",
    "rows_migrated": "migrated_rows_count",
    "last_skew": "last_skew_ratio",
}


class StatsDict(dict):
    """Dict whose keys are canonical schema names but which still
    answers the legacy spellings via ``[]``, ``get`` and ``in``.
    Iteration/``keys()`` expose only canonical names, so conformance
    tests and new consumers see one schema."""

    def __missing__(self, key):
        alias = LEGACY_ALIASES.get(key)
        if alias is not None and dict.__contains__(self, alias):
            return dict.__getitem__(self, alias)
        raise KeyError(key)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __contains__(self, key):
        if dict.__contains__(self, key):
            return True
        alias = LEGACY_ALIASES.get(key)
        return alias is not None and dict.__contains__(self, alias)


def normalize(stats: Dict[str, float],
              extra_aliases: Optional[Dict[str, str]] = None) -> StatsDict:
    """Rewrite legacy spellings in ``stats`` to canonical names,
    returning a compat :class:`StatsDict`."""
    table = dict(LEGACY_ALIASES)
    if extra_aliases:
        table.update(extra_aliases)
    return StatsDict((table.get(k, k), v) for k, v in stats.items())
