"""The stats-key schema of the port (the ``normalize`` part of
repro.obs.schema, with the compat dict it returns).

Every emitted stats key is ``snake_case`` and ends in a unit suffix
(``_s``, ``_bytes``, ``_tokens``, ``_pages``, ``_count``, ``_rate``,
``_ratio``; ``tokens_per_s`` and ``token_hit_rate`` are the blessed
irregular spellings).  The legacy surfaces (``prefix_cache_stats()``,
``tiering_stats()``, ``hotpath_stats()``) return a :class:`StatsDict`:
keys are canonical, but the pre-schema spellings (``hits``,
``restored``, ``bytes_out`` ...) still resolve through ``[]``/``get``/
``in``.
"""
from __future__ import annotations

from typing import Dict, Optional

# legacy spelling -> canonical key, one flat namespace
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
    Iteration/``keys()`` expose only canonical names."""

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
