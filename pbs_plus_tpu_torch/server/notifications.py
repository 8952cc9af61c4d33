"""Notifications: per-job results, batch aggregation, alert scanner.

Reference: internal/server/notification — proxmox-notify spool/sendmail
delivery, batch tracker aggregating multi-job runs with timeout flush,
hourly alert scanner (stale backups, unconfigured/offline targets) with
cooldowns (notification.go:73-247, batch.go:25-356, scanner.go:17-206).

Delivery here is pluggable sinks (callable / file spool); sendmail exec is
gated on availability.

A copy of the JAX package's ``server/notifications.py``, its code byte
for byte apart from its logger (``logging``).  ``Server.notifications``
routes a port server's job results here.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable

from .notify_templates import TemplateSet

L = logging.getLogger(__name__)

Sink = Callable[[str, str, dict], None]     # (severity, title, body)


def file_spool_sink(spool_dir: str) -> Sink:
    os.makedirs(spool_dir, exist_ok=True)
    counter = iter(range(1 << 62))

    def sink(severity: str, title: str, body: dict) -> None:
        name = f"{int(time.time()*1000)}-{next(counter):06d}-{severity}.json"
        with open(os.path.join(spool_dir, name), "w") as f:
            json.dump({"severity": severity, "title": title,
                       "body": body, "time": time.time()}, f)
    return sink


def sendmail_sink(recipient: str) -> Sink | None:
    if shutil.which("sendmail") is None:
        return None

    def sink(severity: str, title: str, body: dict) -> None:
        msg = (f"To: {recipient}\nSubject: [pbs-plus-tpu/{severity}] {title}\n\n"
               + json.dumps(body, indent=1))
        try:
            subprocess.run(["sendmail", "-t"], input=msg.encode(),
                           timeout=30, check=False)
        except Exception:
            L.exception("sendmail delivery failed")
    return sink


@dataclass
class BatchTracker:
    """Aggregates job results of one scheduling wave into a single
    notification, flushed after ``window_s`` of quiet."""

    sink: Sink
    window_s: float = 60.0
    templates: TemplateSet = field(default_factory=TemplateSet)
    _results: list[dict] = field(default_factory=list)
    _flush_task: asyncio.Task | None = None

    def record(self, job_id: str, status: str, detail: str = "") -> None:
        self._results.append({"job": job_id, "status": status,
                              "detail": detail, "time": time.time()})
        if self._flush_task is not None:
            self._flush_task.cancel()
        self._flush_task = asyncio.create_task(self._flush_later())

    async def _flush_later(self) -> None:
        try:
            await asyncio.sleep(self.window_s)
        except asyncio.CancelledError:
            return
        # sinks may block (sendmail) — keep them off the event loop
        await asyncio.get_running_loop().run_in_executor(None, self.flush)

    def flush(self) -> None:
        if not self._results:
            return
        results, self._results = self._results, []
        bad = [r for r in results if r["status"] not in ("success",)]
        severity = "error" if any(r["status"] == "error" for r in results) \
            else ("warning" if bad else "info")
        body = {"results": results, "total": len(results),
                "ok_count": len(results) - len(bad), "bad_count": len(bad)}
        body["text"] = self.templates.render("batch-summary", body)
        self.sink(severity,
                  f"{len(results)} job(s): "
                  f"{len(results) - len(bad)} ok, {len(bad)} not ok",
                  body)


class AlertScanner:
    """Periodic health alerts with cooldown (reference: hourly scanner)."""

    def __init__(self, server, sink: Sink, *, interval_s: float = 3600.0,
                 stale_after_s: float = 2 * 86400.0,
                 cooldown_s: float = 6 * 3600.0,
                 quiet_days: set[int] | None = None,
                 quiet_hours: tuple[int, int] | None = None,
                 templates: TemplateSet | None = None):
        """``quiet_days`` (0=Mon..6=Sun) and ``quiet_hours`` ([start,end)
        local hours, may wrap midnight) suppress warning-level alerts —
        errors always deliver (reference: scanner cooldown/quiet-days,
        internal/server/notification/scanner.go:17-206)."""
        self.server = server
        self.sink = sink
        self.interval_s = interval_s
        self.stale_after_s = stale_after_s
        self.cooldown_s = cooldown_s
        self.quiet_days = quiet_days or set()
        self.quiet_hours = quiet_hours
        self.templates = templates or TemplateSet()
        self._last_alert: dict[str, float] = {}
        self._stop = asyncio.Event()

    def reload_settings(self) -> None:
        """Apply operator-set alert settings from the DB (web API:
        /api2/json/d2d/alert-settings) — keys: quiet_days ("5,6"),
        quiet_hours ("22-6"), cooldown_s, stale_after_s.  Runs every
        scan, so a settings change takes effect without a restart."""
        try:
            st = self.server.db.list_alert_settings()
        except Exception:
            return
        try:
            if "quiet_days" in st:
                self.quiet_days = {int(x) % 7 for x in
                                   st["quiet_days"].split(",") if x.strip()}
            if "quiet_hours" in st:
                if st["quiet_hours"].strip():
                    a, _, b = st["quiet_hours"].partition("-")
                    self.quiet_hours = (int(a) % 24, int(b) % 24)
                else:
                    self.quiet_hours = None
            if "cooldown_s" in st:
                self.cooldown_s = float(st["cooldown_s"])
            if "stale_after_s" in st:
                self.stale_after_s = float(st["stale_after_s"])
        except (ValueError, TypeError) as e:
            L.warning("bad alert settings ignored: %s", e)

    def scan(self) -> list[tuple[str, str, dict]]:
        self.reload_settings()
        alerts = []
        now = time.time()
        for j in self.server.db.list_backup_jobs(enabled_only=True):
            if j.schedule and (j.last_run_at or 0) < now - self.stale_after_s:
                alerts.append(("warning", f"backup {j.id} is stale",
                               {"template": "alert-stale-backup",
                                "job": j.id, "last_run": j.last_run_at,
                                "schedule": j.schedule}))
            if j.last_status == "error":
                alerts.append(("error", f"backup {j.id} failing",
                               {"template": "alert-backup-failing",
                                "job": j.id, "error": j.last_error}))
        connected = {s.cn for s in self.server.agents.sessions()}
        for t in self.server.db.list_targets():
            if t["kind"] == "agent" and t["hostname"] not in connected:
                alerts.append(("warning",
                               f"target {t['name']} offline",
                               {"template": "alert-target-offline",
                                "target": t["name"]}))
        alerts.extend(self._datastore_usage_alert())
        return alerts

    def _datastore_usage_alert(self) -> list[tuple[str, str, dict]]:
        """Filesystem fill alert for the datastore volume (threshold via
        alert setting datastore_usage_pct, default 90; errors at 98)."""
        try:
            pct = float(self.server.db.get_alert_setting(
                "datastore_usage_pct", "90"))
        except ValueError:
            pct = 90.0
        try:
            sv = os.statvfs(self.server.config.datastore_dir)
        except OSError:
            return []
        total = sv.f_blocks * sv.f_frsize
        if not total:
            return []
        used = total - sv.f_bavail * sv.f_frsize
        used_pct = 100.0 * used / total
        if used_pct < pct:
            return []
        sev = "error" if used_pct >= 98.0 else "warning"
        return [(sev, "datastore volume filling up",
                 {"template": "alert-datastore-usage",
                  "percent": round(used_pct, 1), "used": used,
                  "total": total})]

    def _quiet_now(self, now: float) -> bool:
        lt = time.localtime(now)
        if lt.tm_wday in self.quiet_days:
            return True
        if self.quiet_hours is not None:
            a, b = self.quiet_hours
            h = lt.tm_hour
            return (a <= h < b) if a <= b else (h >= a or h < b)
        return False

    def _emit(self, alerts) -> None:
        now = time.time()
        quiet = self._quiet_now(now)
        for severity, title, body in alerts:
            if quiet and severity != "error":
                continue                 # warnings wait out quiet windows
            # cooldown per (severity, title): an escalation (warning →
            # error, e.g. the fill alert crossing 98%) must deliver
            # immediately, not wait out the warning's cooldown
            key = f"{severity}:{title}"
            if now - self._last_alert.get(key, 0) < self.cooldown_s:
                continue
            self._last_alert[key] = now
            tmpl = body.get("template")
            if tmpl:
                try:
                    body = dict(body, text=self.templates.render(tmpl, body))
                except KeyError:
                    pass
            self.sink(severity, title, body)

    async def run(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._stop.is_set():
            try:
                alerts = await loop.run_in_executor(None, self.scan)
                await loop.run_in_executor(None, self._emit, alerts)
            except Exception:
                L.exception("alert scan failed")
            try:
                await asyncio.wait_for(self._stop.wait(), self.interval_s)
            except asyncio.TimeoutError:
                pass

    def stop(self) -> None:
        self._stop.set()
