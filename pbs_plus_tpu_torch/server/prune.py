"""Prune + garbage collection: retention policy over snapshot groups,
then mark-and-sweep over the chunk store.

Reference capability: the keep-last/refcount discipline of the
reference's datastore tests (internal/pxarmount/{refcount,
keepLast_chunk}_test.go) and PBS's own prune/GC jobs that PBS-Plus
schedules around.  Policy here mirrors PBS's keep flags (subset):

    keep_last     newest N per group
    keep_daily    newest per calendar day, N days
    keep_weekly   newest per ISO week, N weeks

GC is the PBS two-phase model on this chunk store: phase 1 touches every
chunk referenced by every surviving snapshot (atime mark), phase 2
sweeps chunks untouched since the mark started, with a grace window so
chunks inserted by an in-flight backup session (staged, not yet
published) can never be collected.

A copy of the JAX package's ``server/prune.py``, its code byte for byte
apart from its imports, which name the port's own modules (the
``Datastore``, ``checkpoint`` and ``fswitness``), and its logger
(``logging``).  The sweep runs on the port's ``ChunkStore.sweep``,
which discards each swept digest from the store's ``DedupIndex`` (the
device cuckoo table's host mirror, uploaded to the card on its next
probe) before it unlinks the chunk file."""

from __future__ import annotations

import datetime as dt
import logging
import os
import time
from dataclasses import dataclass, field

from ..pxar.datastore import Datastore, SnapshotRef
from ..utils import fswitness

L = logging.getLogger(__name__)

GC_GRACE_S = 24 * 3600.0      # PBS-style safety window for in-flight data


@dataclass
class PrunePolicy:
    keep_last: int = 0            # 0 = keep all
    keep_daily: int = 0
    keep_weekly: int = 0

    def __post_init__(self) -> None:
        # a negative keep (sign bug in a client) would slice to an empty
        # keep-set and delete the whole group — reject at construction
        for f in ("keep_last", "keep_daily", "keep_weekly"):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be >= 0")

    def empty(self) -> bool:
        return not (self.keep_last or self.keep_daily or self.keep_weekly)


@dataclass
class PruneReport:
    removed: list[str] = field(default_factory=list)
    kept: list[str] = field(default_factory=list)
    chunks_removed: int = 0
    bytes_freed: int = 0
    dry_run: bool = False


def _parse_time(ref: SnapshotRef) -> dt.datetime:
    return dt.datetime.strptime(ref.backup_time, "%Y-%m-%dT%H:%M:%SZ"
                                ).replace(tzinfo=dt.timezone.utc)


def select_keep(snaps: list[SnapshotRef],
                policy: PrunePolicy) -> set[SnapshotRef]:
    """Which snapshots of ONE group survive (PBS keep-flag semantics:
    newest-first, each bucket keeps its newest member, a snapshot kept
    by any rule is kept)."""
    if policy.empty() or not snaps:
        return set(snaps)
    ordered = sorted(snaps, key=lambda r: r.backup_time, reverse=True)
    keep: set[SnapshotRef] = set()
    keep.update(ordered[:policy.keep_last])
    if policy.keep_daily:
        seen_days: set[str] = set()
        for r in ordered:
            day = _parse_time(r).strftime("%Y-%m-%d")
            if day not in seen_days:
                seen_days.add(day)
                keep.add(r)
                if len(seen_days) >= policy.keep_daily:
                    break
    if policy.keep_weekly:
        seen_weeks: set[str] = set()
        for r in ordered:
            week = "{}-W{:02d}".format(*_parse_time(r).isocalendar()[:2])
            if week not in seen_weeks:
                seen_weeks.add(week)
                keep.add(r)
                if len(seen_weeks) >= policy.keep_weekly:
                    break
    return keep


def _live_digest_set(ds: Datastore) -> set[bytes]:
    """Every digest referenced DIRECTLY by a snapshot index or a live
    backup checkpoint (server/checkpoint.py — a crashed job's resume is
    about to splice exactly those chunks)."""
    from . import checkpoint as _checkpoint
    live: set[bytes] = set()
    for ref in ds.list_snapshots(all_namespaces=True):
        try:
            indexes = ds.load_indexes(ref)
        except OSError:
            continue     # snapshot vanished mid-scan (concurrent delete)
        for idx in indexes:
            for i in range(len(idx.ends)):
                live.add(idx.digests[i].tobytes())
    live.update(_checkpoint.live_checkpoint_digests(ds))
    return live


def refold_doomed_bases(ds: Datastore,
                        live: "set[bytes] | None" = None) -> int:
    """Re-delta on GC: a base alive ONLY through
    the delta closure — no snapshot or checkpoint names it — would pin
    disk forever.  Fold the live deltas referencing it down
    (``ChunkStore.refold_deltas``: re-encode against a surviving base,
    or store plain) so the sweep can reclaim it.  MUST run before the
    mark clock is stamped: the reassembly READS the doomed bases, and
    a relatime filesystem refreshes their atime on that read — done
    after ``_file_clock_now`` it would shield every doomed base from
    this run's sweep.  ``live`` lets ``run_prune`` share one snapshot-
    index scan between the refold and the mark (the digest set cannot
    change between them — refolds rewrite chunk ENCODINGS, never
    digests)."""
    if live is None:
        live = _live_digest_set(ds)
    doomed = ds.chunks.delta_closure(live) - live
    if not doomed:
        return 0
    return ds.chunks.refold_deltas(live, doomed)


def mark_live_chunks(ds: Datastore,
                     live: "set[bytes] | None" = None) -> int:
    """GC phase 1: touch every chunk referenced by any snapshot index —
    once per unique digest (a deduplicated store shares chunks across
    many snapshots; per-entry utime would be millions of redundant
    syscalls) — plus live checkpoint references.  The similarity tier's
    delta closure rides on top (docs/data-plane.md "Similarity tier"):
    a delta blob reassembles from its base chunk, so every base a live
    delta (transitively) references is live too even when no snapshot
    index names it — derived from on-disk delta headers, so it holds
    across restarts and with the tier since turned off.  A base whose
    refold failed earlier in the run stays in the closure: the failure
    direction is keep-the-base, never a dangling delta.  The closure is
    always re-derived here (post-refold headers), only the direct
    ``live`` set may be shared by the caller."""
    if live is None:
        live = _live_digest_set(ds)
    closure = ds.chunks.delta_closure(live)
    # shard-parallel mark (pxar/datastore.py touch_many): per-shard
    # utime loops overlap their syscall waits
    ds.chunks.touch_many(closure)
    return len(closure)


def run_prune(ds: Datastore, policy: PrunePolicy, *,
              dry_run: bool = False, gc: bool = True,
              gc_grace_s: float = GC_GRACE_S,
              ckpt_max_age_s: float | None = None) -> PruneReport:
    """Apply ``policy`` to every snapshot group, then (optionally)
    mark-and-sweep the chunk store.  Stale backup checkpoints are
    reaped FIRST (before the mark), so a checkpoint superseded by a
    published snapshot or older than ``ckpt_max_age_s`` stops
    protecting its chunks in the same run."""
    report = PruneReport(dry_run=dry_run)
    groups: dict[tuple[str, str, str], list[SnapshotRef]] = {}
    for ref in ds.list_snapshots(all_namespaces=True):
        groups.setdefault(
            (ref.namespace, ref.backup_type, ref.backup_id),
            []).append(ref)
    for (_ns, _t, _b), snaps in sorted(groups.items()):
        keep = select_keep(snaps, policy)
        for ref in snaps:
            if ref in keep:
                report.kept.append(str(ref))
            else:
                report.removed.append(str(ref))
                if not dry_run:
                    ds.remove_snapshot(ref)
    # GC runs whenever requested — garbage may pre-exist this prune
    # (snapshot DELETE route, an earlier grace-shielded sweep), so it
    # must not be conditional on THIS run having removed anything
    if gc and not dry_run:
        from . import checkpoint as _checkpoint
        _checkpoint.sweep_stale(
            ds, max_age_s=_checkpoint.CKPT_MAX_AGE_S
            if ckpt_max_age_s is None else ckpt_max_age_s)
        # re-delta on GC BEFORE the mark clock: refold's reassembly
        # reads must land before mark_start so the doomed bases stay
        # sweep-eligible in THIS run (see refold_doomed_bases).  The
        # snapshot-index scan is paid ONCE and shared with the mark —
        # digests are immutable, so a refold cannot change the set
        live = _live_digest_set(ds)
        refold_doomed_bases(ds, live=live)
        # mark_start must come from the FILE clock, not time.time(): the
        # kernel stamps utime with the coarse clock, which can lag the
        # precise clock by ~1 ms — a wall-clock mark would sweep chunks
        # touched immediately after it (live-chunk loss)
        mark_start = _file_clock_now(ds.chunks.base)
        mark_live_chunks(ds, live=live)
        fswitness.note("gc.mark", ds.chunks.base)
        # sweep only chunks last touched before BOTH the mark and the
        # grace cutoff — a just-inserted chunk of an in-flight session
        # is always newer than the cutoff
        cutoff = min(mark_start, time.time() - gc_grace_s)
        fswitness.note("gc.sweep", ds.chunks.base)
        report.chunks_removed, report.bytes_freed = \
            ds.chunks.sweep(before=cutoff)
    L.info("prune: removed %d kept %d (dry_run=%s, %d chunks, %d bytes)",
           len(report.removed), len(report.kept), dry_run,
           report.chunks_removed, report.bytes_freed)
    return report


def _file_clock_now(base: str) -> float:
    """'Now' as the filesystem will stamp it (coarse kernel clock)."""
    import tempfile
    fd, p = tempfile.mkstemp(dir=base, prefix=".gc-mark-")
    try:
        os.close(fd)
        return os.stat(p).st_mtime
    finally:
        try:
            os.unlink(p)
        except OSError:
            pass


