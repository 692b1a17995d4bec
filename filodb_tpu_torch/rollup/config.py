"""Rollup subsystem configuration: the resolution ladder + cadence.

Parsed from the per-dataset ``"rollup"`` block of the standalone config
(doc/rollup.md):

    "rollup": {
      "enabled": true,
      "resolutions": ["1m", "15m", "1h"],   # ascending ladder; each a
                                            # multiple of the previous
      "tick-interval-s": 30,                # scheduler cadence
      "raw-retention": "0",                 # 0/omit = raw keeps all;
                                            # else queries older than
                                            # this MUST serve rolled
      "idle-close": "2h",                   # force-close a silent
                                            # series' open periods
                                            # after this wall time
                                            # (0 disables)
      "stall-after-s": 120                  # tier stall gauge trips
                                            # after this many seconds
                                            # without progress while
                                            # work is pending
    }

A broken rollup block refuses startup (like a broken rule config):
silently rolling a subset of the configured tiers is worse than not
starting.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

_DUR_UNITS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000,
              "d": 86_400_000, "w": 7 * 86_400_000, "y": 365 * 86_400_000}


def parse_duration_ms(v: str) -> int:
    """'15s' / '1m' / '250ms' / plain seconds -> millis (the HTTP API's
    duration spelling)."""
    s = v.strip()
    for unit in ("ms", "y", "w", "d", "h", "m", "s"):
        if s.endswith(unit):
            return int(float(s[:-len(unit)]) * _DUR_UNITS[unit])
    return int(float(s) * 1000)


class RollupConfigError(ValueError):
    pass


DEFAULT_RESOLUTIONS_MS = (60_000, 900_000, 3_600_000)  # 1m / 15m / 1h


@dataclasses.dataclass(frozen=True)
class RollupConfig:
    """One dataset's rollup ladder + scheduler knobs."""

    resolutions_ms: tuple = DEFAULT_RESOLUTIONS_MS
    tick_interval_s: float = 30.0
    # raw data older than this is considered unservable from the raw
    # dataset (the retention boundary LongTimeRangePlanner stitches
    # at); None = raw serves its whole history and rolled tiers are
    # used purely for scan-volume profit
    raw_retention_ms: Optional[int] = None
    # a series that stops ingesting holds its final (open) periods in
    # the buffer forever under pure closure semantics; after this wall
    # time without new samples its open periods are force-emitted and
    # the state dropped (None disables — the generative equivalence
    # sweeps run with it off)
    idle_close_s: Optional[float] = 7200.0
    # tier stall detection: the filodb_rollup_stalled level gauge trips
    # when a tier makes no progress for this long while work is pending
    stall_after_s: float = 120.0

    def __post_init__(self):
        res = tuple(int(r) for r in self.resolutions_ms)
        if not res:
            raise RollupConfigError("rollup needs >= 1 resolution")
        if sorted(res) != list(res) or len(set(res)) != len(res):
            raise RollupConfigError(
                f"rollup resolutions must be strictly ascending: {res}")
        if res[0] < 1000:
            raise RollupConfigError(
                f"rollup resolutions must be >= 1s: {res}")
        for fine, coarse in zip(res, res[1:]):
            if coarse % fine != 0:
                raise RollupConfigError(
                    f"each rollup resolution must be a multiple of the "
                    f"previous (cascade + period alignment): {coarse} "
                    f"% {fine} != 0")
        object.__setattr__(self, "resolutions_ms", res)
        if self.tick_interval_s <= 0:
            raise RollupConfigError("tick-interval-s must be > 0")

    @property
    def finest_ms(self) -> int:
        return self.resolutions_ms[0]

    @property
    def coarsest_ms(self) -> int:
        return self.resolutions_ms[-1]

    @staticmethod
    def from_config(conf: dict) -> "RollupConfig":
        """Parse the standalone ``"rollup"`` block (durations in the
        Prometheus spelling, e.g. ``"15m"``)."""
        conf = dict(conf or {})
        known = {"enabled", "resolutions", "tick-interval-s",
                 "raw-retention", "idle-close", "stall-after-s",
                 "store", "query"}
        unknown = sorted(set(conf) - known)
        if unknown:
            # a misspelled knob silently applying the default is the
            # broken-rule-config failure mode: refuse startup instead
            raise RollupConfigError(
                f"unknown rollup config key(s) {unknown} "
                f"(known: {sorted(known)})")
        kwargs: dict = {}
        if "resolutions" in conf:
            try:
                kwargs["resolutions_ms"] = tuple(
                    parse_duration_ms(str(r)) for r in conf["resolutions"])
            except (ValueError, TypeError) as e:
                raise RollupConfigError(
                    f"bad rollup resolutions {conf['resolutions']!r}: "
                    f"{e}") from e
        if "tick-interval-s" in conf:
            kwargs["tick_interval_s"] = float(conf["tick-interval-s"])
        if conf.get("raw-retention") not in (None, 0, "0"):
            kwargs["raw_retention_ms"] = parse_duration_ms(
                str(conf["raw-retention"]))
        if "idle-close" in conf:
            idle = parse_duration_ms(str(conf["idle-close"])) \
                if conf["idle-close"] not in (0, "0", None) else None
            kwargs["idle_close_s"] = idle / 1000.0 \
                if idle is not None else None
        if "stall-after-s" in conf:
            kwargs["stall_after_s"] = float(conf["stall-after-s"])
        try:
            cfg = RollupConfig(**kwargs)
        except RollupConfigError:
            raise
        except (TypeError, ValueError) as e:
            raise RollupConfigError(f"bad rollup config: {e}") from e
        if cfg.idle_close_s is not None \
                and cfg.idle_close_s * 1000 < cfg.coarsest_ms:
            # an idle window shorter than the coarsest period would
            # force-close EVERY open coarse period mid-way for any
            # series scraped slower than the window — partial records
            # the complete ones could then never replace (tests use
            # the bare constructor for accelerated idle-close)
            raise RollupConfigError(
                f"idle-close ({cfg.idle_close_s}s) must cover the "
                f"coarsest resolution ({cfg.coarsest_ms // 1000}s)")
        return cfg
