"""Sampling CPU profiler — the pprof CPU-profile analog.

Reference role: the pprof handlers the reference mounts on every
process (internal/server/web/server.go:135-139 mounts net/http/pprof on
the API mux; internal/agent/cli/entry.go:59-79 serves it from the agent).
Go's CPU profile is a signal-driven sampler; the Python twin here samples
``sys._current_frames()`` from a dedicated thread — process-wide (all
threads, unlike cProfile), low-overhead, and pure stdlib.

Output is a dict with two views of the same samples:

- ``top``: per-function flat/cumulative sample counts (pprof ``top``);
- ``collapsed``: semicolon-joined stacks with counts — the folded format
  flamegraph tooling consumes directly (pprof ``-raw`` role).

A copy of the JAX package's ``utils/profiling.py``, its code byte for
byte.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter

MAX_SECONDS = 60.0
MIN_INTERVAL_S = 0.001
DEFAULT_INTERVAL_S = 0.005


def capture_profile(seconds: float, *, interval_s: float = DEFAULT_INTERVAL_S,
                    top_limit: int = 60,
                    collapsed_limit: int = 200) -> dict:
    """Sample every thread's stack for ``seconds``; returns the profile
    dict.  Must run OFF the threads being measured (callers use a
    dedicated thread / executor) — the sampler excludes its own thread.
    """
    seconds = max(0.05, min(float(seconds), MAX_SECONDS))
    interval_s = max(MIN_INTERVAL_S, float(interval_s))
    stacks: Counter[tuple] = Counter()
    me = threading.get_ident()
    names = {}
    n_samples = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            stack = []
            f = frame
            while f is not None:
                co = f.f_code
                stack.append(f"{co.co_name} "
                             f"({co.co_filename}:{f.f_lineno})")
                f = f.f_back
            stacks[(names.get(ident, str(ident)),
                    tuple(reversed(stack)))] += 1
        n_samples += 1
        time.sleep(interval_s)
    elapsed = time.perf_counter() - t0

    flat: Counter[str] = Counter()
    cum: Counter[str] = Counter()
    for (_, stack), n in stacks.items():
        flat[stack[-1]] += n
        for fn in set(stack):
            cum[fn] += n
    top = [{"func": fn, "self": flat.get(fn, 0), "cum": c}
           for fn, c in cum.most_common(top_limit)]
    collapsed = [f"{thread};" + ";".join(stack) + f" {n}"
                 for (thread, stack), n in stacks.most_common(collapsed_limit)]
    return {
        "seconds": round(elapsed, 3),
        "interval_s": interval_s,
        "samples": n_samples,
        "threads": sorted(set(t for (t, _) in stacks)),
        "top": top,
        "collapsed": collapsed,
    }


async def profile_rpc(req, ctx):
    """Shared aRPC handler: both the agent daemon and the job child
    register this under ``"profile"`` (pprof on every process)."""
    import asyncio
    payload = req.payload or {}
    return await asyncio.to_thread(
        capture_profile, float(payload.get("seconds", 2.0)))


def render_top(profile: dict, limit: int = 30) -> str:
    """Human-readable ``top`` table (the pprof CLI view)."""
    lines = [f"samples={profile['samples']} "
             f"seconds={profile['seconds']} "
             f"interval={profile['interval_s'] * 1000:.0f}ms",
             f"{'self':>6} {'cum':>6}  function"]
    for row in profile["top"][:limit]:
        lines.append(f"{row['self']:>6} {row['cum']:>6}  {row['func']}")
    return "\n".join(lines)
