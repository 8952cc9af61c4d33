"""systemd-style calendar event expressions.

Reference: internal/calendar/calendar.go:27 (Parse), :541 (ComputeNextEvent).
The reference implements the systemd.time calendar-event grammar used by PBS
schedules.  Supported here (the subset PBS schedules actually use):

- keywords: ``minutely hourly daily weekly monthly yearly``
- ``[DOW[,DOW|DOW..DOW]] [date] [time]`` where
  - DOW: ``mon tue wed thu fri sat sun`` (ranges ``mon..fri``, lists)
  - date: ``*-*-*`` / ``YYYY-MM-DD`` with ``*``, lists, ranges, ``/step``
  - time: ``HH:MM[:SS]`` with the same value grammar per field
- value grammar per field: ``*``, ``*/N``, ``a``, ``a..b``, ``a..b/N``,
  comma-joined lists.

A copy of the JAX package's ``utils/calendar.py``, its code byte for
byte: the scheduler and the prune loop evaluate their schedules here.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field

_DOW = {"mon": 0, "tue": 1, "wed": 2, "thu": 3, "fri": 4, "sat": 5, "sun": 6}

_KEYWORDS = {
    "minutely": "*-*-* *:*:00",
    "hourly": "*-*-* *:00:00",
    "daily": "*-*-* 00:00:00",
    "weekly": "mon *-*-* 00:00:00",
    "monthly": "*-*-01 00:00:00",
    "yearly": "*-01-01 00:00:00",
    "annually": "*-01-01 00:00:00",
}


class CalendarError(ValueError):
    pass


def _parse_field(spec: str, lo: int, hi: int, name: str) -> frozenset[int] | None:
    """Parse one date/time field into an allowed-value set (None == any)."""
    if spec == "*":
        return None
    allowed: set[int] = set()
    for part in spec.split(","):
        step = 1
        has_step = False
        if "/" in part:
            part, step_s = part.split("/", 1)
            has_step = True
            try:
                step = int(step_s)
            except ValueError:
                raise CalendarError(f"bad step in {name}: {step_s!r}")
            if step <= 0:
                raise CalendarError(f"step must be positive in {name}")
        if part == "*":
            a, b = lo, hi
        elif ".." in part:
            a_s, b_s = part.split("..", 1)
            try:
                a, b = int(a_s), int(b_s)
            except ValueError:
                raise CalendarError(f"bad range in {name}: {part!r}")
        else:
            try:
                a = int(part)
            except ValueError:
                raise CalendarError(f"bad value in {name}: {part!r}")
            # systemd: "a/N" == from a to field max, step N (even N=1)
            b = hi if has_step else a
        if not (lo <= a <= hi and lo <= b <= hi and a <= b):
            raise CalendarError(f"{name} out of range [{lo},{hi}]: {part!r}")
        allowed.update(range(a, b + 1, step))
    return frozenset(allowed)


def _parse_dow(spec: str) -> frozenset[int]:
    out: set[int] = set()
    for part in spec.lower().split(","):
        if ".." in part:
            a_s, b_s = part.split("..", 1)
            if a_s not in _DOW or b_s not in _DOW:
                raise CalendarError(f"bad weekday range {part!r}")
            a, b = _DOW[a_s], _DOW[b_s]
            if a <= b:
                out.update(range(a, b + 1))
            else:  # wrap (sat..mon)
                out.update(range(a, 7))
                out.update(range(0, b + 1))
        else:
            if part not in _DOW:
                raise CalendarError(f"bad weekday {part!r}")
            out.add(_DOW[part])
    return frozenset(out)


@dataclass(frozen=True)
class CalendarEvent:
    expression: str
    weekdays: frozenset[int] | None = None   # 0=mon
    years: frozenset[int] | None = None
    months: frozenset[int] | None = None
    days: frozenset[int] | None = None
    hours: frozenset[int] | None = field(default_factory=lambda: frozenset({0}))
    minutes: frozenset[int] | None = field(default_factory=lambda: frozenset({0}))
    seconds: frozenset[int] | None = field(default_factory=lambda: frozenset({0}))

    def matches(self, t: _dt.datetime) -> bool:
        def ok(allowed: frozenset[int] | None, v: int) -> bool:
            return allowed is None or v in allowed
        return (
            ok(self.weekdays, t.weekday())
            and ok(self.years, t.year)
            and ok(self.months, t.month)
            and ok(self.days, t.day)
            and ok(self.hours, t.hour)
            and ok(self.minutes, t.minute)
            and ok(self.seconds, t.second)
        )

    def next_event(self, after: _dt.datetime) -> _dt.datetime | None:
        """First matching instant strictly after ``after`` (reference:
        ComputeNextEvent).  Walks day-by-day, then picks the first matching
        h/m/s inside the day — bounded to 4 years out."""
        t = after.replace(microsecond=0) + _dt.timedelta(seconds=1)
        limit = after + _dt.timedelta(days=4 * 366)
        day = t.date()
        first = True
        while True:
            d = _dt.datetime.combine(day, _dt.time.min, tzinfo=t.tzinfo)
            if d > limit:
                return None
            if (
                (self.weekdays is None or d.weekday() in self.weekdays)
                and (self.years is None or d.year in self.years)
                and (self.months is None or d.month in self.months)
                and (self.days is None or d.day in self.days)
            ):
                floor_h = t.hour if first else 0
                hit = self._first_time_in_day(
                    floor_h,
                    t.minute if first else 0,
                    t.second if first else 0,
                )
                if hit is not None:
                    h, m, s = hit
                    return d.replace(hour=h, minute=m, second=s)
            day = day + _dt.timedelta(days=1)
            first = False

    def _first_time_in_day(self, fh: int, fm: int, fs: int):
        hours = sorted(self.hours) if self.hours is not None else range(24)
        minutes = sorted(self.minutes) if self.minutes is not None else range(60)
        seconds = sorted(self.seconds) if self.seconds is not None else range(60)
        for h in hours:
            if h < fh:
                continue
            for m in minutes:
                if h == fh and m < fm:
                    continue
                for s in seconds:
                    if h == fh and m == fm and s < fs:
                        continue
                    return (h, m, s)
        return None


def parse(expr: str) -> CalendarEvent:
    """Parse a calendar expression (reference: calendar.Parse)."""
    raw = expr.strip().lower()
    if not raw:
        raise CalendarError("empty calendar expression")
    raw = _KEYWORDS.get(raw, raw)
    parts = raw.split()

    weekdays = None
    if parts and parts[0][:3] in _DOW:
        weekdays = _parse_dow(parts[0])
        parts = parts[1:]

    date_spec = None
    time_spec = None
    for p in parts:
        if ":" in p:
            if time_spec is not None:
                raise CalendarError(f"duplicate time in {expr!r}")
            time_spec = p
        elif "-" in p:
            if date_spec is not None:
                raise CalendarError(f"duplicate date in {expr!r}")
            date_spec = p
        else:
            raise CalendarError(f"unrecognized component {p!r} in {expr!r}")

    years = months = days = None
    if date_spec is not None:
        dparts = date_spec.split("-")
        if len(dparts) == 2:
            dparts = ["*"] + dparts
        if len(dparts) != 3:
            raise CalendarError(f"bad date {date_spec!r}")
        years = _parse_field(dparts[0], 1970, 2199, "year")
        months = _parse_field(dparts[1], 1, 12, "month")
        days = _parse_field(dparts[2], 1, 31, "day")

    if time_spec is not None:
        tparts = time_spec.split(":")
        if len(tparts) == 2:
            tparts.append("00")
        if len(tparts) != 3:
            raise CalendarError(f"bad time {time_spec!r}")
        hours = _parse_field(tparts[0], 0, 23, "hour")
        minutes = _parse_field(tparts[1], 0, 59, "minute")
        seconds = _parse_field(tparts[2], 0, 59, "second")
    else:
        # bare weekday / date → midnight (systemd semantics)
        hours = frozenset({0})
        minutes = frozenset({0})
        seconds = frozenset({0})

    return CalendarEvent(
        expression=expr, weekdays=weekdays, years=years, months=months,
        days=days, hours=hours, minutes=minutes, seconds=seconds,
    )


def compute_next_event(expr: str, after: _dt.datetime) -> _dt.datetime | None:
    return parse(expr).next_event(after)
