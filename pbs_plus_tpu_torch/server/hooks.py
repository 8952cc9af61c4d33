"""Hook-script execution: pre/post job shell hooks with the env/feedback
protocol.

Reference: internal/server/jobs/{env,shell}.go + backup/job.go:459-482 —
every job field is exported as ``PBS_PLUS__<FIELD>`` env; the script's
stdout ``KEY=VALUE`` lines feed back.  Supported overrides here:
``SOURCE`` (redirect the backup source) and ``EXCLUDE`` (append an
exclusion pattern) — the reference's NAMESPACE override is a PBS
datastore concept this build's local datastore doesn't have, so it is
deliberately not accepted.  A job's ``pre_script``/``post_script`` is
either inline shell or ``script:<name>`` referencing the reusable
scripts table (web CRUD at /api2/json/d2d/script).

A copy of the JAX package's ``server/hooks.py``, its code byte for byte
apart from its logger (``logging``)."""

from __future__ import annotations

import asyncio
import logging
import os

L = logging.getLogger(__name__)

HOOK_TIMEOUT_S = 300.0
_FEEDBACK_KEYS = {"SOURCE", "EXCLUDE"}   # allowed overrides


def job_env(row, extra: dict | None = None) -> dict[str, str]:
    """PBS_PLUS__* env for a BackupJobRow (reference: jobs/env.go)."""
    env = dict(os.environ)
    fields = {
        "JOB_ID": row.id, "TARGET": row.target, "SOURCE": row.source_path,
        "STORE": row.store, "BACKUP_ID": row.backup_id or row.target,
        "SCHEDULE": row.schedule, "CHUNKER": row.chunker,
        "EXCLUSIONS": ":".join(row.exclusions),
    }
    if extra:
        fields.update(extra)
    for k, v in fields.items():
        env[f"PBS_PLUS__{k}"] = str(v)
    return env


def resolve_script(db, ref: str) -> str | None:
    """Inline shell, or ``script:<name>`` from the scripts table."""
    if not ref:
        return None
    if ref.startswith("script:"):
        row = db.get_script(ref[len("script:"):])
        if row is None:
            raise RuntimeError(f"unknown hook script {ref!r}")
        return row["content"]
    return ref


async def run_hook(script: str, env: dict[str, str], *,
                   log=None) -> dict[str, str]:
    """Run one hook; returns the KEY=VALUE stdout feedback.  Non-zero
    exit fails the job (the reference aborts on pre-script failure)."""
    log = log or L
    proc = await asyncio.create_subprocess_shell(
        script, env=env,
        stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.PIPE)
    try:
        out, err = await asyncio.wait_for(proc.communicate(),
                                          HOOK_TIMEOUT_S)
    except asyncio.TimeoutError:
        proc.kill()
        await proc.wait()
        raise RuntimeError(f"hook script timed out after {HOOK_TIMEOUT_S}s")
    if err.strip():
        log.info("hook stderr: %s", err.decode(errors="replace")[:2000])
    if proc.returncode != 0:
        raise RuntimeError(
            f"hook script exited {proc.returncode}: "
            f"{err.decode(errors='replace')[:300]}")
    feedback: dict[str, str] = {}
    for line in out.decode(errors="replace").splitlines():
        if "=" not in line:
            continue
        k, _, v = line.partition("=")
        k = k.strip()
        if k in _FEEDBACK_KEYS:
            feedback[k] = v.strip()
    return feedback
