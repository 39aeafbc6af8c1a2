"""Time binning: epoch time -> (period bin, offset within period).

A copy of the reference package's `curve/binned_time.py` (pure NumPy):
the week bins the Z3 stats sketch is keyed by.

Parity: org.locationtech.geomesa.curve.BinnedTime / TimePeriod (geomesa-z3)
[upstream, unverified]. The Z3/XZ3 indices bin time into fixed periods
(day/week/month/year; week is the Z3 default) so that the time dimension of
the curve stays bounded; a query interval maps to one (bin, offset-range) per
touched period.

Divergence from upstream noted explicitly: offsets here are uniformly
*seconds* as float64 for all periods (upstream mixes millis/seconds/minutes by
period); bins are int32 counts since the 1970-01-01 epoch. Month bins are
calendar months (year*12+month); month/year offsets are seconds from the start
of the calendar period, normalized against the period's maximum length.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np

_DAY_S = 86400.0
_WEEK_S = 7 * 86400.0
# Max period lengths (for dimension normalization): longest month = 31 days,
# longest (leap) year = 366 days.
_MONTH_MAX_S = 31 * 86400.0
_YEAR_MAX_S = 366 * 86400.0
_EPOCH_DOW_OFFSET_DAYS = 4  # 1970-01-01 was a Thursday; ISO weeks start Monday


class TimePeriod(enum.Enum):
    DAY = "day"
    WEEK = "week"
    MONTH = "month"
    YEAR = "year"

    @classmethod
    def parse(cls, s: "str | TimePeriod") -> "TimePeriod":
        if isinstance(s, TimePeriod):
            return s
        return cls(s.lower())


@dataclasses.dataclass(frozen=True)
class BinnedTime:
    bin: int
    offset_seconds: float


def max_offset_seconds(period: TimePeriod) -> float:
    return {
        TimePeriod.DAY: _DAY_S,
        TimePeriod.WEEK: _WEEK_S,
        TimePeriod.MONTH: _MONTH_MAX_S,
        TimePeriod.YEAR: _YEAR_MAX_S,
    }[period]


def to_binned_time(epoch_millis, period: TimePeriod) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized: epoch millis -> (bin int32 array, offset-seconds f64 array)."""
    ms = np.asarray(epoch_millis, dtype=np.int64)
    secs = ms.astype(np.float64) / 1000.0
    if period is TimePeriod.DAY:
        bins = np.floor_divide(ms, np.int64(86400_000))
        offs = secs - bins.astype(np.float64) * _DAY_S
    elif period is TimePeriod.WEEK:
        days = np.floor_divide(ms, np.int64(86400_000)) + _EPOCH_DOW_OFFSET_DAYS
        bins = np.floor_divide(days, 7)
        week_start_ms = (bins * 7 - _EPOCH_DOW_OFFSET_DAYS) * np.int64(86400_000)
        offs = (ms - week_start_ms).astype(np.float64) / 1000.0
    else:
        dt = ms.astype("datetime64[ms]")
        months = dt.astype("datetime64[M]")
        years = dt.astype("datetime64[Y]")
        if period is TimePeriod.MONTH:
            bins = months.astype(np.int64)  # months since 1970-01
            offs = (ms - months.astype("datetime64[ms]").astype(np.int64)).astype(
                np.float64
            ) / 1000.0
        else:
            bins = years.astype(np.int64)  # years since 1970
            offs = (ms - years.astype("datetime64[ms]").astype(np.int64)).astype(
                np.float64
            ) / 1000.0
    return bins.astype(np.int32), offs


def bin_to_epoch_millis(bin_index: int, period: TimePeriod) -> int:
    """Start of a period bin, as epoch millis."""
    if period is TimePeriod.DAY:
        return int(bin_index) * 86400_000
    if period is TimePeriod.WEEK:
        return (int(bin_index) * 7 - _EPOCH_DOW_OFFSET_DAYS) * 86400_000
    if period is TimePeriod.MONTH:
        return int(np.datetime64(int(bin_index), "M").astype("datetime64[ms]").astype(np.int64))
    return int(np.datetime64(int(bin_index), "Y").astype("datetime64[ms]").astype(np.int64))


def bins_for_interval(start_millis: int, end_millis: int, period: TimePeriod):
    """All (bin, offset_lo_s, offset_hi_s) triples covering [start, end]."""
    out = []
    b0, o0 = to_binned_time(np.int64(start_millis), period)
    b1, o1 = to_binned_time(np.int64(end_millis), period)
    b0, b1 = int(b0), int(b1)
    for b in range(b0, b1 + 1):
        lo = float(o0) if b == b0 else 0.0
        hi = float(o1) if b == b1 else max_offset_seconds(period)
        out.append((b, lo, hi))
    return out
