"""Time quantum views: the port's copy of pilosa_tpu/core/timeq.py.

A time field materializes one view per time unit present in its quantum
("YMDH" subsets): `<name>_2019`, `<name>_201907`, `<name>_20190704`,
`<name>_2019070415`. Range queries compute the minimal covering set of views
by walking up from small units to large and back down (Pilosa's
viewsByTimeRange). Unix seconds convert to naive UTC datetimes, as
`datetime.utcfromtimestamp` gave them.
"""

from __future__ import annotations

from datetime import datetime, timedelta, timezone
from typing import List

TIME_FORMAT = "%Y-%m-%dT%H:%M"  # Pilosa's "2006-01-02T15:04"

VALID_QUANTUMS = {"Y", "YM", "YMD", "YMDH", "M", "MD", "MDH", "D", "DH", "H", ""}


def validate_quantum(q: str) -> None:
    if q not in VALID_QUANTUMS:
        raise ValueError(f"invalid time quantum {q!r}")


def parse_time(t) -> datetime:
    """Accepts Pilosa's formats: a '2006-01-02T15:04' string or unix
    seconds."""
    if isinstance(t, str):
        return datetime.strptime(t, TIME_FORMAT)
    if isinstance(t, (int, float)):
        return datetime.fromtimestamp(int(t), timezone.utc).replace(tzinfo=None)
    if isinstance(t, datetime):
        return t
    raise ValueError("arg must be a timestamp")


def view_by_time_unit(name: str, t: datetime, unit: str) -> str:
    if unit == "Y":
        return f"{name}_{t.strftime('%Y')}"
    if unit == "M":
        return f"{name}_{t.strftime('%Y%m')}"
    if unit == "D":
        return f"{name}_{t.strftime('%Y%m%d')}"
    if unit == "H":
        return f"{name}_{t.strftime('%Y%m%d%H')}"
    return ""


def views_by_time(name: str, t: datetime, quantum: str) -> List[str]:
    """All unit views a timestamped bit lands in."""
    return [v for unit in quantum if (v := view_by_time_unit(name, t, unit))]


def _add_month(t: datetime) -> datetime:
    # clamp to day 1 for late-month days to avoid Jan 31 + 1mo = Mar 2
    if t.day > 28:
        t = t.replace(day=1)
    if t.month == 12:
        return t.replace(year=t.year + 1, month=1)
    return t.replace(month=t.month + 1)


def _add_year(t: datetime) -> datetime:
    try:
        return t.replace(year=t.year + 1)
    except ValueError:  # Feb 29 + 1y normalizes to Mar 1 (Go AddDate)
        return t.replace(year=t.year + 1, month=3, day=1)


def _next_year_gte(t: datetime, end: datetime) -> bool:
    nxt = _add_year(t)
    return nxt.year == end.year or end > nxt


def _go_add_months(t: datetime, n: int) -> datetime:
    """Go time.AddDate(0,n,0) semantics: day overflow normalizes forward
    (Jan 31 + 1mo = Mar 2/3)."""
    y = t.year + (t.month - 1 + n) // 12
    m = (t.month - 1 + n) % 12 + 1
    return datetime(y, m, 1, t.hour, t.minute) + timedelta(days=t.day - 1)


def _next_month_gte(t: datetime, end: datetime) -> bool:
    nxt = _go_add_months(t, 1)
    if (nxt.year, nxt.month) == (end.year, end.month):
        return True
    return end > nxt


def _next_day_gte(t: datetime, end: datetime) -> bool:
    nxt = t + timedelta(days=1)
    if (nxt.year, nxt.month, nxt.day) == (end.year, end.month, end.day):
        return True
    return end > nxt


def min_max_view_times(view_names, quantum: str):
    """Time span covered by existing time views: (min_start, max_end_exclusive),
    or (None, None) when there are no time views."""
    suffixes = []
    for vname in view_names:
        suffix = vname.rsplit("_", 1)[-1]
        if suffix.isdigit() and len(suffix) in (4, 6, 8, 10):
            suffixes.append(suffix)
    if not suffixes:
        return None, None
    lo, hi = min(suffixes), max(suffixes)
    fmts = {4: "%Y", 6: "%Y%m", 8: "%Y%m%d", 10: "%Y%m%d%H"}

    def start_of(s: str) -> datetime:
        return datetime.strptime(s, fmts[len(s)])

    def end_of(s: str) -> datetime:
        t = start_of(s)
        if len(s) == 4:
            return _add_year(t)
        if len(s) == 6:
            return _go_add_months(t, 1)
        if len(s) == 8:
            return t + timedelta(days=1)
        return t + timedelta(hours=1)

    return start_of(lo), end_of(hi)


def views_by_time_range(name: str, start: datetime, end: datetime, quantum: str) -> List[str]:
    """Minimal covering view set for [start, end)."""
    has_y = "Y" in quantum
    has_m = "M" in quantum
    has_d = "D" in quantum
    has_h = "H" in quantum

    t = start
    results: List[str] = []

    # Walk up from smallest units to largest.
    if has_h or has_d or has_m:
        while t < end:
            if has_h:
                if not _next_day_gte(t, end):
                    break
                elif t.hour != 0:
                    results.append(view_by_time_unit(name, t, "H"))
                    t = t + timedelta(hours=1)
                    continue
            if has_d:
                if not _next_month_gte(t, end):
                    break
                elif t.day != 1:
                    results.append(view_by_time_unit(name, t, "D"))
                    t = t + timedelta(days=1)
                    continue
            if has_m:
                if not _next_year_gte(t, end):
                    break
                elif t.month != 1:
                    results.append(view_by_time_unit(name, t, "M"))
                    t = _add_month(t)
                    continue
            break

    # Walk back down from largest units to smallest.
    while t < end:
        if has_y and _next_year_gte(t, end):
            results.append(view_by_time_unit(name, t, "Y"))
            t = _add_year(t)
        elif has_m and _next_month_gte(t, end):
            results.append(view_by_time_unit(name, t, "M"))
            t = _add_month(t)
        elif has_d and _next_day_gte(t, end):
            results.append(view_by_time_unit(name, t, "D"))
            t = t + timedelta(days=1)
        elif has_h:
            results.append(view_by_time_unit(name, t, "H"))
            t = t + timedelta(hours=1)
        else:
            break

    return results
