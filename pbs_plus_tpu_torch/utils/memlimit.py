"""Memory-limit awareness (reference: internal/server/memlimit.go:10-20 —
GOMEMLIMIT = 0.9 × cgroup/system limit, refreshed every minute).

Python has no GC memory target; the analog here surfaces the effective
limit so sizing decisions (buffer pools, jobs.Manager concurrency,
sha-batch sizes) derive from it, with an optional RLIMIT_AS clamp.

A copy of the JAX package's ``utils/memlimit.py``, its code byte for
byte.  ``apply_rlimit`` clamps ``RLIMIT_AS``: under that clamp CUDA's
virtual-address reservations at ``cuInit`` fail, so no path of the port
calls it, and a process that touches the card must not (call it, if at
all, in a child that never initialises CUDA).
"""

from __future__ import annotations

import os
import resource


def _cgroup_limit() -> int | None:
    for path in ("/sys/fs/cgroup/memory.max",
                 "/sys/fs/cgroup/memory/memory.limit_in_bytes"):
        try:
            with open(path) as f:
                raw = f.read().strip()
            if raw in ("max", ""):
                continue
            v = int(raw)
            if 0 < v < (1 << 60):
                return v
        except (OSError, ValueError):
            continue
    return None


def _system_total() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 4 << 30


def effective_limit(fraction: float = 0.9) -> int:
    """0.9 × min(cgroup limit, system RAM)."""
    cg = _cgroup_limit()
    total = _system_total()
    base = min(cg, total) if cg else total
    return int(base * fraction)


def apply_rlimit(fraction: float = 0.9) -> int:
    """Clamp the address space to the effective limit (best effort)."""
    limit = effective_limit(fraction)
    try:
        soft, hard = resource.getrlimit(resource.RLIMIT_AS)
        if hard == resource.RLIM_INFINITY or limit < hard:
            resource.setrlimit(resource.RLIMIT_AS,
                               (limit, hard))
    except (ValueError, OSError):
        pass
    return limit
