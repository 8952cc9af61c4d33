"""HTTP API (reference: internal/server/web — ~60 HTTPS routes on
:8017/:8018 with middleware chain SecurityHeaders→RateLimit→Recovery→
RequestLogger→RequestID, PBS-ticket auth for UI routes, bearer/bootstrap
auth for agent routes, Prometheus /plus/metrics, healthz/readyz).

aiohttp application; route groups:

  agent side (reference :8018):
    POST /plus/agent/bootstrap        CSR + bootstrap token → signed cert
    POST /plus/agent/renew            mTLS-bootstrapped host renews its cert
  api side (reference :8017):
    GET  /plus/healthz | /plus/readyz
    GET  /plus/metrics                     Prometheus text
    GET/POST/DELETE /api2/json/d2d/backup        job CRUD
    POST /api2/json/d2d/backup/{id}/run          trigger now
    GET/POST /api2/json/d2d/target               targets
    POST /api2/json/d2d/restore                  start restore
    GET  /api2/json/d2d/snapshots                datastore listing
    GET  /api2/json/d2d/tasks[/{upid}]           task logs
    GET  /api2/json/d2d/exclusion (+POST)        exclusions
    POST /api2/json/d2d/token                    issue bootstrap token
    GET  /api2/json/d2d/filetree?target=&path=   live agent browse
    GET/POST /api2/json/d2d/verification         verification jobs
    GET/POST/DELETE /api2/json/d2d/sync          sync jobs (replication)

Auth: API routes use bearer tokens minted by ``api_token`` (sealed in DB);
with ``pbs_auth_key_path`` configured (PBS-host drop-in) the middleware
also accepts the PBS UI's auth cookie, verified against PBS's own
ticket-signing key (``server/pbsauth.py``, the web/auth.go analog).

A copy of the JAX package's ``server/web.py``, its code byte for byte
apart from its imports, which name the port's own modules, its logger
(``logging``) and three changes.  ``POST .../verification/{id}/run``
hands the server's device to ``enqueue_verification``, so K2 re-hashes
on the server's card.  The agent bundle (``/plus/agent/pyz``) packs this
package, ``pbs_plus_tpu_torch``, and runs its ``__main__.main``; its
freshness scan looks at every file of the package, not only ``*.py``,
since the package also ships CUDA sources (``ops/csrc/*.cu``) and the
simhash projection (``ops/simhash_projection.npz``).  A backup job's
chunker defaults to the server's (``"cuda"`` in the port).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import secrets
import threading
import time
import uuid
from typing import TYPE_CHECKING

from aiohttp import web

from ..utils import atomicio, fsio, trace
from ..utils.singleflight import SingleFlight
from . import database
from .metrics import MetricsRegistry

if TYPE_CHECKING:
    from .store import Server

L = logging.getLogger(__name__)


@web.middleware
async def security_headers(request: web.Request, handler):
    resp = await handler(request)
    resp.headers.setdefault("X-Content-Type-Options", "nosniff")
    resp.headers.setdefault("X-Frame-Options", "DENY")
    resp.headers.setdefault("Referrer-Policy", "no-referrer")
    return resp


@web.middleware
async def recovery(request: web.Request, handler):
    try:
        return await handler(request)
    except web.HTTPException:
        raise
    except Exception as e:
        L.exception("http handler crashed: %s %s", request.method,
                    request.path)
        return web.json_response({"error": f"{type(e).__name__}: {e}"},
                                 status=500)


@web.middleware
async def request_id(request: web.Request, handler):
    rid = uuid.uuid4().hex[:12]
    request["request_id"] = rid
    resp = await handler(request)
    resp.headers["X-Request-ID"] = rid
    return resp


def _secret_candidates(sec: str) -> list[bytes]:
    """Token secrets travel hex-encoded (as minted/printed); accept raw
    ascii secrets too.  Shared by the auth middleware and bootstrap."""
    out = [sec.encode()]
    try:
        out.insert(0, bytes.fromhex(sec))
    except ValueError:
        pass
    return out


class RateLimiter:
    def __init__(self, rate: float = 50.0, burst: int = 100):
        self.rate, self.burst = rate, burst
        self._buckets: dict[str, tuple[float, float]] = {}

    def allow(self, key: str) -> bool:
        now = time.monotonic()
        if len(self._buckets) > 4096:
            # evict buckets idle long enough to have fully refilled
            idle = self.burst / self.rate
            self._buckets = {k: v for k, v in self._buckets.items()
                             if now - v[1] < idle}
        tokens, last = self._buckets.get(key, (float(self.burst), now))
        tokens = min(self.burst, tokens + (now - last) * self.rate)
        if tokens < 1.0:
            self._buckets[key] = (tokens, now)
            return False
        self._buckets[key] = (tokens - 1.0, now)
        return True


def traces_payload(n: "str | int | None" = None,
                   trace_id: "str | None" = None) -> list:
    """The traces endpoint's answer, split out so the span ring contract
    is testable without standing up the TLS/web stack."""
    try:
        limit = min(int(n), 10_000) if n is not None else 256
    except (TypeError, ValueError):
        limit = 256
    if limit <= 0:
        return []
    return trace.recent(limit, trace_id=trace_id or None)


def build_app(server: "Server", *, require_auth: bool = True) -> web.Application:
    metrics = MetricsRegistry(server)
    limiter = RateLimiter()
    from .pbsauth import (
        load_authenticator, load_csrf_validator, parse_allowed_users)
    ticket_auth = load_authenticator(
        getattr(server.config, "pbs_auth_key_path", ""))
    csrf_auth = load_csrf_validator(
        getattr(server.config, "pbs_csrf_key_path", ""))
    ticket_users = parse_allowed_users(
        getattr(server.config, "pbs_auth_allowed_users", ""))

    @web.middleware
    async def rate_limit(request: web.Request, handler):
        peer = request.remote or "?"
        if not limiter.allow(peer):
            return web.json_response({"error": "rate limited"}, status=429)
        return await handler(request)

    @web.middleware
    async def auth(request: web.Request, handler):
        # install.sh/pyz are open like the reference's agent binary
        # download (the artifact is this public package); /plus/ui is a
        # static shell whose API calls carry the operator's token
        open_paths = ("/plus/healthz", "/plus/readyz", "/plus/metrics",
                      "/plus/agent/bootstrap", "/plus/agent/renew",
                      "/plus/agent/install.sh", "/plus/agent/install.ps1",
                      "/plus/agent/pyz",
                      "/plus/agent/binary", "/plus/agent/version",
                      "/plus/agent/signer.pub", "/plus/ui")
        if not require_auth or request.path in open_paths:
            return await handler(request)
        hdr = request.headers.get("Authorization", "")
        authorized = False
        if hdr.startswith("Bearer "):
            tok = hdr[7:]
            if ":" in tok:
                tid, sec = tok.split(":", 1)
                try:
                    authorized = any(
                        server.db.check_token(tid, c, kind="api")
                        for c in _secret_candidates(sec))
                except Exception:
                    authorized = False
        if not authorized and ticket_auth is not None:
            # PBS-host drop-in: the PBS UI's own auth cookie signs the
            # operator in (reference internal/server/web/auth.go:297-321).
            # Cookie auth alone covers safe methods only; writes need a
            # CSRFPreventionToken (browsers attach cookies cross-origin —
            # real PBS enforces the same; the reference sidecar doesn't).
            cookie = (request.cookies.get("__Host-PBSAuthCookie")
                      or request.cookies.get("PBSAuthCookie"))
            if cookie:
                ticket = ticket_auth.verify_ticket(cookie)
                if (ticket is not None
                        and (ticket_users is None
                             or ticket.userid in ticket_users)):
                    if request.method in ("GET", "HEAD", "OPTIONS"):
                        authorized = True
                    elif csrf_auth is not None and csrf_auth.verify_token(
                            request.headers.get("CSRFPreventionToken", ""),
                            ticket.userid):
                        authorized = True
                    if authorized:
                        request["pbs_userid"] = ticket.userid
        if not authorized:
            return web.json_response({"error": "unauthorized"}, status=401)
        return await handler(request)

    app = web.Application(middlewares=[
        security_headers, rate_limit, recovery, request_id, auth,
    ], client_max_size=16 << 20)

    # -- health / metrics --------------------------------------------------
    async def healthz(request):
        return web.json_response({"ok": True})

    async def readyz(request):
        try:
            server.db.list_targets()
            return web.json_response({"ok": True})
        except Exception as e:
            return web.json_response({"ok": False, "error": str(e)},
                                     status=503)

    async def metrics_handler(request):
        # render() does sync DB queries and (on cache expiry) a chunk-dir
        # walk — keep the whole scrape off the event loop
        text = await asyncio.get_running_loop().run_in_executor(
            None, metrics.render)
        return web.Response(text=text, content_type="text/plain")

    # -- agent bootstrap / renew ------------------------------------------
    async def agent_bootstrap(request):
        body = await request.json()
        raw = body.get("token_secret", "")
        last_err: Exception = PermissionError("invalid bootstrap token")
        for secret in _secret_candidates(raw):
            try:
                cert = server.bootstrap_agent(
                    body["hostname"], body["csr"].encode(),
                    body["token_id"], secret,
                    drives=body.get("drives"))
                break
            except ValueError as e:       # invalid hostname → client error
                return web.json_response({"error": str(e)}, status=400)
            except PermissionError as e:
                last_err = e
        else:
            return web.json_response({"error": str(last_err)}, status=403)
        return web.json_response({
            "cert": cert.decode(),
            "ca": await fsio.aread_text(server.certs.ca_cert_path),
        })

    async def agent_renew(request):
        body = await request.json()
        hostname = body["hostname"]
        row = server.db.get_agent_host(hostname)
        if row is None:
            return web.json_response({"error": "unknown host"}, status=403)
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.serialization import (
            Encoding, PublicFormat)
        try:
            csr = x509.load_pem_x509_csr(body["csr"].encode())
        except Exception:
            return web.json_response({"error": "bad CSR"}, status=400)
        # renewal proof: the CSR must be self-signed by the SAME keypair as
        # the stored cert (possession of the private key), and its CN must
        # match the hostname — fingerprint knowledge alone is public info
        stored = x509.load_pem_x509_certificate(row["cert_pem"])
        same_key = csr.public_key().public_bytes(
            Encoding.DER, PublicFormat.SubjectPublicKeyInfo) == \
            stored.public_key().public_bytes(
                Encoding.DER, PublicFormat.SubjectPublicKeyInfo)
        cn_attrs = csr.subject.get_attributes_for_oid(
            x509.oid.NameOID.COMMON_NAME)
        cn_ok = bool(cn_attrs) and str(cn_attrs[0].value) == hostname
        if not (csr.is_signature_valid and same_key and cn_ok):
            return web.json_response({"error": "renewal proof failed"},
                                     status=403)
        cert = server.certs.sign_csr(body["csr"].encode())
        fp = x509.load_pem_x509_certificate(cert).fingerprint(
            hashes.SHA256()).hex()
        import json as _json
        drives = _json.loads(row["drives"] or "[]")   # preserve inventory
        server.db.upsert_agent_host(hostname, cert, fp, drives)
        return web.json_response({"cert": cert.decode()})

    # -- backup job CRUD ---------------------------------------------------
    def _job_dict(j: database.BackupJobRow) -> dict:
        return {
            "id": j.id, "target": j.target, "source_path": j.source_path,
            "backup_id": j.backup_id, "namespace": j.namespace,
            "schedule": j.schedule,
            "retry": j.retry, "retry_interval_s": j.retry_interval_s,
            "exclusions": j.exclusions, "chunker": j.chunker,
            "pipeline_workers": j.pipeline_workers,
            "store": j.store,
            "enabled": j.enabled, "last_run_at": j.last_run_at,
            "last_status": j.last_status, "last_error": j.last_error,
            "last_snapshot": j.last_snapshot,
            "running": server.jobs.is_active(f"backup:{j.id}"),
        }

    async def backup_list(request):
        return web.json_response(
            {"data": [_job_dict(j) for j in server.db.list_backup_jobs()]})

    async def backup_upsert(request):
        b = await request.json()
        from ..utils import validate
        from .backup_job import (validate_chunker_kind,
                                 validate_pipeline_workers)
        chunker = b.get("chunker", server.config.chunker)
        validate_chunker_kind(chunker)  # reject unknown backends up front
        try:
            pipeline_workers = validate_pipeline_workers(
                b.get("pipeline_workers", server.config.pipeline_workers))
        except (TypeError, ValueError) as e:
            return web.json_response({"error": str(e)}, status=400)
        store_kind = b.get("store", "")
        if store_kind not in ("", "local", "pbs"):
            return web.json_response(
                {"error": f"unknown store {store_kind!r} "
                          "(want local | pbs)"}, status=400)
        if store_kind == "pbs" and not server.config.pbs_url:
            return web.json_response(
                {"error": "store='pbs' but no PBS push target configured "
                          "(ServerConfig.pbs_url)"}, status=400)
        row = database.BackupJobRow(
            id=validate.job_id(b["id"]), target=b["target"],
            source_path=b["source_path"],
            store="pbs" if store_kind == "pbs" else "",
            backup_id=validate.snapshot_component(b["backup_id"])
            if b.get("backup_id") else "",
            namespace=validate.namespace_path(b.get("namespace", "")),
            schedule=b.get("schedule", ""), retry=int(b.get("retry", 0)),
            retry_interval_s=int(b.get("retry_interval_s", 60)),
            exclusions=list(b.get("exclusions", [])),
            chunker=chunker,
            pipeline_workers=pipeline_workers,
            enabled=bool(b.get("enabled", True)))
        server.db.upsert_backup_job(row)
        return web.json_response({"data": _job_dict(row)})

    async def backup_delete(request):
        server.db.delete_backup_job(request.match_info["id"])
        return web.json_response({"ok": True})

    async def backup_run(request):
        job_id = request.match_info["id"]
        try:
            started = server.enqueue_backup(job_id)
        except KeyError:
            return web.json_response({"error": "unknown job"}, status=404)
        return web.json_response({"started": started})

    # -- targets -----------------------------------------------------------
    async def target_list(request):
        connected = {s.cn for s in server.agents.sessions()}
        out = []
        for t in server.db.list_targets():
            t["connected"] = t["hostname"] in connected
            out.append(t)
        return web.json_response({"data": out})

    # target reachability cache (reference: D2DTargetStatusHandler,
    # targets.go:80-99 — cached statuses, ?refresh=true probes live)
    target_status_cache: dict[str, dict] = {}
    server.target_status_cache = target_status_cache    # test probe
    # ?refresh=true fans out live probes (10s RPC timeout per agent); a
    # stampede of concurrent refreshes must share ONE probe pass
    status_flight = SingleFlight()
    server.status_flight = status_flight                # test probe

    async def _probe_target(t: dict) -> dict:
        from ..arpc import Session
        name, kind = t["name"], t["kind"]
        out = {"name": name, "kind": kind, "checked_at": time.time()}
        if kind == "agent":
            sess = server.agents.get(t["hostname"] or name)
            if sess is None:
                return {**out, "status": "offline"}
            try:
                r = await Session(sess.conn).call(
                    "target_status",
                    {"path": t.get("root_path") or "/"}, timeout=10)
                return {**out,
                        "status": "online" if r.data.get("ok")
                        else "path-missing"}
            except Exception as e:
                return {**out, "status": f"error: {type(e).__name__}"}
        if kind == "local":
            ok = os.path.isdir(t.get("root_path") or "")
            return {**out, "status": "online" if ok else "path-missing"}
        if kind == "s3":
            cfg = t.get("config") or {}
            ok = all(cfg.get(k) for k in ("endpoint", "bucket",
                                          "access_key", "secret_key"))
            return {**out, "status": "configured" if ok
                    else "misconfigured"}
        return {**out, "status": "unknown-kind"}

    async def target_status(request):
        if request.query.get("refresh", "").lower() == "true":

            async def _refresh_all():
                results = await asyncio.gather(
                    *(_probe_target(t) for t in server.db.list_targets()))
                # full rebuild, not upsert: deleted/renamed targets must
                # not linger as ghost "online" entries
                target_status_cache.clear()
                target_status_cache.update({r["name"]: r for r in results})

            await status_flight.do("target-status", _refresh_all)
        return web.json_response(
            {"data": sorted(target_status_cache.values(),
                            key=lambda r: r["name"])})

    async def target_upsert(request):
        b = await request.json()
        from ..utils import validate
        name = b.get("name", "")
        # the target name becomes the default backup id, i.e. a datastore
        # path component — validate at mint time so every snapshot created
        # from it stays reachable through parse_snapshot_ref
        try:
            validate.snapshot_component(name)
            if b.get("hostname"):
                validate.hostname(b["hostname"])
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)
        server.db.upsert_target(name, b.get("kind", "agent"),
                                hostname=b.get("hostname", name),
                                root_path=b.get("root_path", ""),
                                config=b.get("config"))
        return web.json_response({"ok": True})

    # -- restore -----------------------------------------------------------
    async def restore_start(request):
        b = await request.json()
        from ..pxar.datastore import parse_snapshot_ref
        from .restore_job import enqueue_restore
        try:
            parse_snapshot_ref(b["snapshot"])   # reject traversal/bad type
        except (KeyError, ValueError) as e:
            return web.json_response({"error": str(e)}, status=400)
        from .jobs import QueueFullError
        try:
            rid = enqueue_restore(server, target=b["target"],
                                  snapshot=b["snapshot"],
                                  destination=b["destination"],
                                  subpath=b.get("subpath", ""))
        except QueueFullError as e:
            # backpressure, not a server fault: tell the client to retry
            return web.json_response({"error": str(e)}, status=503)
        return web.json_response({"restore_id": rid})

    async def restore_status(request):
        r = server.db.get_restore(request.match_info["rid"])
        if r is None:
            return web.json_response({"error": "not found"}, status=404)
        return web.json_response({"data": r})

    # -- snapshots ---------------------------------------------------------
    async def snapshots(request):
        ds = server.datastore.datastore
        out = []
        for ref in ds.list_snapshots(all_namespaces=True):
            item = {"snapshot": str(ref), "type": ref.backup_type,
                    "id": ref.backup_id, "time": ref.backup_time}
            if ref.namespace:
                item["ns"] = ref.namespace
            try:
                man = ds.load_manifest(ref)
                item.update(entries=man.get("entries"),
                            payload_size=man.get("payload_size"),
                            previous=man.get("previous"))
            except Exception:
                item["manifest_error"] = True
            out.append(item)
        return web.json_response({"data": out})

    # -- tasks -------------------------------------------------------------
    async def tasks(request):
        job = request.query.get("job")
        return web.json_response(
            {"data": server.db.list_tasks(job_id=job or None)})

    async def task_get(request):
        t = server.db.get_task(request.match_info["upid"])
        if t is None:
            return web.json_response({"error": "not found"}, status=404)
        return web.json_response({"data": t})

    # -- exclusions --------------------------------------------------------
    async def exclusion_list(request):
        return web.json_response(
            {"data": server.db.list_exclusions(request.query.get("job", ""))})

    async def exclusion_add(request):
        b = await request.json()
        server.db.add_exclusion(b["pattern"], b.get("job", ""),
                                b.get("comment", ""))
        return web.json_response({"ok": True})

    # -- tokens ------------------------------------------------------------
    async def token_create(request):
        b = await request.json() if request.can_read_body else {}
        ttl = float(b.get("ttl_s", 3600))
        tid, secret = server.issue_bootstrap_token(ttl_s=ttl)
        return web.json_response({"token_id": tid,
                                  "token_secret": secret.hex()})

    # -- filetree (live agent browse) --------------------------------------
    async def filetree(request):
        target = request.query.get("target", "")
        path = request.query.get("path", "/")
        sess = server.agents.get(target)
        if sess is None:
            return web.json_response({"error": "agent offline"}, status=503)
        from ..arpc import Session
        resp = await Session(sess.conn).call("filetree", {"path": path})
        return web.json_response({"data": resp.data["entries"]})

    # -- zip subtree download ---------------------------------------------
    async def snapshot_zip(request):
        snap = request.query.get("snapshot", "")
        path = request.query.get("path", "")
        from ..pxar import chunkcache
        from ..pxar.datastore import parse_snapshot_ref
        from ..pxar.transfer import SplitReader
        from ..pxar.zipdl import zip_subtree
        ZIP_MAX_BYTES = 1 << 30      # cap logical payload per download

        def build():
            ref = parse_snapshot_ref(snap)   # rejects traversal components
            reader = SplitReader.open_snapshot(server.datastore.datastore,
                                               ref,
                                               cache=chunkcache.shared_cache())
            sub = path.strip("/")
            total = sum(e.size for e in reader.entries()
                        if e.is_file and (not sub or e.path == sub
                                          or e.path.startswith(sub + "/")))
            if total > ZIP_MAX_BYTES:
                raise OverflowError(
                    f"subtree is {total} bytes (> {ZIP_MAX_BYTES}); use a "
                    f"restore job instead")
            return zip_subtree(reader, path), ref
        try:
            buf, ref = await asyncio.get_running_loop().run_in_executor(
                None, build)
        except (FileNotFoundError, TypeError, ValueError) as e:
            return web.json_response({"error": str(e)}, status=404)
        except OverflowError as e:
            return web.json_response({"error": str(e)}, status=413)
        import re as _re
        name = _re.sub(r"[^A-Za-z0-9._-]+", "_",
                       path.strip("/") or ref.backup_id) + ".zip"
        return web.Response(
            body=buf.getvalue(), content_type="application/zip",
            headers={"Content-Disposition": f'attachment; filename="{name}"'})

    # -- debug (reference: net/http/pprof on the API mux) ------------------
    async def debug_tasks(request):
        out = []
        for t in asyncio.all_tasks():
            out.append({"name": t.get_name(), "done": t.done(),
                        "coro": str(t.get_coro())[:120]})
        return web.json_response({"data": out})

    async def debug_stats(request):
        import threading
        return web.json_response({
            "jobs": server.jobs.stats,
            "agents": len(server.agents.sessions()),
            "threads": threading.active_count(),
            "tasks": len(asyncio.all_tasks()),
        })

    async def traces(request):
        """The trace ring (docs/observability.md): closed spans, oldest
        first.  ``?trace=<id>`` filters to one trace, ``?n=`` bounds the
        answer (default 256 — the ring itself is the hard cap)."""
        return web.json_response({"data": traces_payload(
            request.query.get("n"), request.query.get("trace"))})

    _profile_lock = asyncio.Lock()

    async def debug_profile(request):
        """CPU-profile capture (the pprof /debug/pprof/profile analog;
        reference internal/server/web/server.go:135-139).  Body:
        ``{"seconds": N}`` profiles this server process;
        ``{"target": host}`` RPCs the agent daemon;
        ``{"target": host, "backup_id": job}`` reaches the running job
        child through its data session.  ``?format=text`` renders the
        pprof-``top`` table instead of JSON."""
        from ..utils.profiling import MAX_SECONDS, capture_profile, render_top
        b = await request.json() if request.can_read_body else {}
        if not isinstance(b, dict):
            return web.json_response({"error": "body must be an object"},
                                     status=400)
        try:
            seconds = float(b.get("seconds", 2.0))
        except (TypeError, ValueError):
            return web.json_response({"error": "bad seconds"}, status=400)
        if not (0 < seconds <= MAX_SECONDS):
            return web.json_response(
                {"error": f"seconds must be in (0, {MAX_SECONDS:.0f}]"},
                status=400)
        target = b.get("target", "")
        if _profile_lock.locked():
            return web.json_response({"error": "profile already running"},
                                     status=409)
        async with _profile_lock:
            if target:
                cid = target
                sess = server.agents.get(cid)
                if b.get("backup_id"):
                    # job sessions carry a per-run suffix
                    # ("<host>|<job>-<run>"): resolve by prefix
                    pfx = f"{target}|{b['backup_id']}"
                    live = [s for s in server.agents.sessions()
                            if s.client_id == pfx
                            or s.client_id.startswith(pfx + "-")]
                    cid = pfx
                    sess = live[0] if live else None
                if sess is None:
                    return web.json_response(
                        {"error": f"no live session for {cid!r}"},
                        status=503)
                from ..arpc import Session
                resp = await Session(sess.conn).call(
                    "profile", {"seconds": seconds},
                    timeout=seconds + 30.0)
                prof = resp.data
            else:
                prof = await asyncio.get_running_loop().run_in_executor(
                    None, capture_profile, seconds)
        if request.query.get("format") == "text":
            return web.Response(text=render_top(prof),
                                content_type="text/plain")
        return web.json_response({"data": prof})

    # -- snapshot mounts ---------------------------------------------------
    def _mount_service():
        if getattr(server, "mount_service", None) is None:
            from .mount_service import MountService
            server.mount_service = MountService(server)
        return server.mount_service

    async def mount_create(request):
        b = await request.json()
        from ..pxar.datastore import parse_snapshot_ref
        try:
            # validated before the ref string reaches the mount
            # subprocess argv
            parse_snapshot_ref(b.get("snapshot", ""))
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)
        try:
            m = await _mount_service().mount(b["snapshot"],
                                             fuse=bool(b.get("fuse", True)))
        except (RuntimeError, TimeoutError) as e:
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response({"mount_id": m.mount_id,
                                  "mountpoint": m.mountpoint})

    async def mount_list(request):
        return web.json_response({"data": _mount_service().list()})

    async def mount_delete(request):
        ok = await _mount_service().unmount(request.match_info["mid"])
        if not ok:
            return web.json_response({"error": "unknown mount"}, status=404)
        return web.json_response({"ok": True})

    async def drives(request):
        target = request.query.get("target", "")
        sess = server.agents.get(target)
        if sess is None:
            return web.json_response({"error": "agent offline"}, status=503)
        from ..arpc import Session
        resp = await Session(sess.conn).call("drives", {})
        return web.json_response({"data": resp.data["drives"]})

    # -- verification ------------------------------------------------------
    async def verification_list(request):
        return web.json_response({"data": server.db.list_verification_jobs()})

    async def verification_upsert(request):
        b = await request.json()
        server.db.upsert_verification_job(
            b["id"], store=b.get("store", ""), schedule=b.get("schedule", ""),
            sample_rate=float(b.get("sample_rate", 0.1)),
            run_on_backup=bool(b.get("run_on_backup", False)))
        return web.json_response({"ok": True})

    async def verification_run(request):
        from .verification_job import enqueue_verification
        vid = request.match_info["id"]
        rows = [v for v in server.db.list_verification_jobs()
                if v["id"] == vid]
        if not rows:
            return web.json_response({"error": "unknown job"}, status=404)
        v = dict(rows[0])
        if request.can_read_body:
            try:
                body = await request.json()
                if isinstance(body, dict) and body.get("check_source"):
                    v["check_source"] = True   # agent-side drift cross-check
            except ValueError:
                pass
        return web.json_response(
            {"started": enqueue_verification(server, v,
                                             device=server.device)})

    # -- sync jobs (datastore replication, docs/sync.md) -------------------
    async def sync_list(request):
        rows = []
        for r in server.db.list_sync_jobs():
            r = dict(r)
            # the peer bearer token grants write access to the remote
            # store — it must never echo back to API readers
            r["remote_token"] = "***" if r.get("remote_token") else ""
            rows.append(r)
        return web.json_response({"data": rows})

    async def sync_upsert(request):
        b = await request.json()
        token = b.get("remote_token", "")
        if token == "***":
            # a client resubmitting the redacted listing keeps the
            # stored secret instead of clobbering it with the mask
            row = server.db.get_sync_job(b.get("id", ""))
            token = row["remote_token"] if row else ""
        try:
            server.db.upsert_sync_job(
                b["id"], direction=b.get("direction", "pull"),
                remote_url=b.get("remote_url", ""),
                remote_token=token,
                peer_path=b.get("peer_path", ""),
                backup_type=b.get("backup_type", ""),
                backup_id=b.get("backup_id", ""),
                namespace=b.get("namespace", ""),
                schedule=b.get("schedule", ""),
                enabled=bool(b.get("enabled", True)))
        except (KeyError, ValueError) as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response({"ok": True})

    async def sync_delete(request):
        server.db.delete_sync_job(request.match_info["id"])
        return web.json_response({"ok": True})

    async def sync_run(request):
        from .sync_job import enqueue_sync
        row = server.db.get_sync_job(request.match_info["id"])
        if row is None:
            return web.json_response({"error": "unknown job"}, status=404)
        return web.json_response({"started": enqueue_sync(server, row)})

    async def sync_results(request):
        row = server.db.get_sync_job(request.match_info["id"])
        if row is None:
            return web.json_response({"error": "unknown job"}, status=404)
        report = {}
        if row.get("last_report"):
            try:
                report = json.loads(row["last_report"])
            except ValueError:
                pass
        return web.json_response({"data": {
            "id": row["id"], "last_run_at": row["last_run_at"],
            "last_status": row["last_status"], "report": report}})

    app.router.add_get("/plus/healthz", healthz)
    app.router.add_get("/plus/readyz", readyz)
    app.router.add_get("/plus/metrics", metrics_handler)
    app.router.add_post("/plus/agent/bootstrap", agent_bootstrap)
    app.router.add_post("/plus/agent/renew", agent_renew)
    app.router.add_get("/api2/json/d2d/backup", backup_list)
    app.router.add_post("/api2/json/d2d/backup", backup_upsert)
    app.router.add_delete("/api2/json/d2d/backup/{id}", backup_delete)
    app.router.add_post("/api2/json/d2d/backup/{id}/run", backup_run)
    app.router.add_get("/api2/json/d2d/target", target_list)
    app.router.add_post("/api2/json/d2d/target", target_upsert)
    app.router.add_post("/api2/json/d2d/restore", restore_start)
    app.router.add_get("/api2/json/d2d/restore/{rid}", restore_status)
    app.router.add_get("/api2/json/d2d/snapshots", snapshots)
    app.router.add_get("/api2/json/d2d/tasks", tasks)
    app.router.add_get("/api2/json/d2d/tasks/{upid}", task_get)
    app.router.add_get("/api2/json/d2d/exclusion", exclusion_list)
    app.router.add_post("/api2/json/d2d/exclusion", exclusion_add)
    app.router.add_post("/api2/json/d2d/token", token_create)
    app.router.add_get("/api2/json/d2d/filetree", filetree)
    app.router.add_get("/api2/json/d2d/snapshot-zip", snapshot_zip)
    app.router.add_get("/plus/debug/tasks", debug_tasks)
    app.router.add_get("/plus/debug/stats", debug_stats)
    app.router.add_get("/api2/json/d2d/traces", traces)
    app.router.add_post("/plus/debug/profile", debug_profile)
    app.router.add_post("/api2/json/d2d/mount", mount_create)
    app.router.add_get("/api2/json/d2d/mount", mount_list)
    app.router.add_delete("/api2/json/d2d/mount/{mid}", mount_delete)
    app.router.add_get("/api2/json/d2d/drives", drives)
    # -- breadth routes ----------------------------------------------------
    async def target_delete(request):
        server.db.delete_target(request.match_info["name"])
        target_status_cache.pop(request.match_info["name"], None)
        return web.json_response({"ok": True})

    async def script_list(request):
        return web.json_response({"data": server.db.list_scripts()})

    async def script_upsert(request):
        b = await request.json()
        try:
            server.db.upsert_script(b["name"], b["content"],
                                    b.get("description", ""))
        except (KeyError, ValueError) as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response({"ok": True})

    async def script_delete(request):
        server.db.delete_script(request.match_info["name"])
        return web.json_response({"ok": True})

    async def restores_list(request):
        return web.json_response({"data": server.db.list_restores()})

    async def token_list(request):
        return web.json_response({"data": server.db.list_tokens()})

    async def token_delete(request):
        server.db.revoke_token(request.match_info["tid"])
        return web.json_response({"ok": True})

    async def exclusion_delete(request):
        try:
            eid = int(request.match_info["eid"])
        except ValueError:
            return web.json_response({"error": "bad exclusion id"},
                                     status=400)
        server.db.delete_exclusion(eid)
        return web.json_response({"ok": True})

    async def verification_results(request):
        v = server.db.get_verification_job(request.match_info["id"])
        if v is None:
            return web.json_response({"error": "unknown job"}, status=404)
        v["last_report"] = json.loads(v.get("last_report") or "{}")
        return web.json_response({"data": v})

    async def verification_export(request):
        """CSV export of the stored verification report (reference:
        verification export/CSV, web/server.go route set)."""
        v = server.db.get_verification_job(request.match_info["id"])
        if v is None:
            return web.json_response({"error": "unknown job"}, status=404)
        rep = json.loads(v.get("last_report") or "{}")
        import csv
        import io
        buf = io.StringIO()
        w = csv.writer(buf)
        w.writerow(["verification", "run_at", "status", "checked",
                    "corrupt_count"])
        w.writerow([v["id"], v.get("last_run_at") or "",
                    v.get("last_status") or "", rep.get("checked", 0),
                    len(rep.get("corrupt", []))])
        w.writerow([])
        w.writerow(["snapshot"])
        for s in rep.get("snapshots", []):
            w.writerow([s])
        if rep.get("corrupt"):
            w.writerow([])
            w.writerow(["corrupt_snapshot", "corrupt_file"])
            for c in rep["corrupt"]:
                for fpath in c.get("files", []) or [""]:
                    w.writerow([c.get("snapshot", ""), fpath])
        return web.Response(
            text=buf.getvalue(), content_type="text/csv",
            headers={"Content-Disposition":
                     f'attachment; filename="verify-{v["id"]}.csv"'})

    async def verification_aggregate(request):
        """Fleet-wide verification health in one response (reference:
        VerificationAggregateHandler, verification_handlers.go:518-551)."""
        jobs = server.db.list_verification_jobs()
        agg = {"total_jobs": len(jobs), "passed": 0, "failed": 0,
               "never_run": 0, "snapshots_checked": 0,
               "corrupt_files": 0, "last_run_at": None}
        for v in jobs:
            if not v.get("last_run_at"):
                agg["never_run"] += 1
                continue
            rep = json.loads(v.get("last_report") or "{}")
            status = v.get("last_status") or ""
            agg["passed" if status == database.STATUS_SUCCESS
                else "failed"] += 1
            agg["snapshots_checked"] += len(rep.get("snapshots", []))
            # corrupt entries are {"snapshot", "files": [...]} — count
            # the FILES, not the per-snapshot reports
            agg["corrupt_files"] += sum(
                len(c.get("files", [])) for c in rep.get("corrupt", []))
            if agg["last_run_at"] is None or \
                    v["last_run_at"] > agg["last_run_at"]:
                agg["last_run_at"] = v["last_run_at"]
        return web.json_response({"data": agg})

    async def backup_export_csv(request):
        """CSV export of every backup job + last-run state (reference:
        ExtJsBackupCSVExportHandler, export_handlers.go:15-45)."""
        import csv
        import io
        jobs = server.db.list_backup_jobs()
        if not jobs:
            return web.Response(status=204)
        buf = io.StringIO()
        w = csv.writer(buf)
        w.writerow(["id", "store", "ns", "target", "source_path",
                    "schedule", "chunker", "pipeline_workers", "enabled",
                    "last_run_at",
                    "last_status", "last_error", "last_snapshot"])
        for j in jobs:
            w.writerow([j.id, j.store or "local", j.namespace, j.target,
                        j.source_path, j.schedule, j.chunker,
                        j.pipeline_workers,
                        int(j.enabled), j.last_run_at or "",
                        j.last_status or "", j.last_error or "",
                        j.last_snapshot or ""])
        return web.Response(
            text=buf.getvalue(), content_type="text/csv",
            headers={"Content-Disposition":
                     'attachment; filename="disk-backups.csv"'})

    async def push_update(request):
        """Push an immediate self-update to connected agents (reference:
        ExtJsPushUpdateHandler, push_update.go — TargetSvc.PushUpdate
        fanned out over the agents' update RPC)."""
        from ..arpc import Session
        try:
            body = await request.json()
        except Exception:
            body = {}
        req_hosts = body.get("hostnames")
        if req_hosts is not None and not (
                isinstance(req_hosts, list)
                and all(isinstance(h, str) for h in req_hosts)):
            return web.json_response(
                {"error": "hostnames must be a list of strings"},
                status=400)
        import math
        try:
            timeout = float(body.get("timeout") or 30.0)
        except (TypeError, ValueError):
            timeout = None
        if timeout is None or not math.isfinite(timeout):
            return web.json_response(
                {"error": "timeout must be a finite number"}, status=400)
        timeout = min(max(timeout, 1.0), 300.0)
        # dedupe: a host with live job sessions appears once per session
        # in sessions(), and duplicate RPCs would race the agent's swap.
        # An explicit [] means "push to nobody", not "push fleet-wide" —
        # only an absent field selects all connected agents.
        hostnames = list(dict.fromkeys(
            req_hosts if req_hosts is not None
            else sorted({s.cn for s in server.agents.sessions()})))

        async def one(host: str) -> dict:
            sess = server.agents.get(host)
            if sess is None:
                return {"hostname": host, "updated": False,
                        "message": "agent offline"}
            try:
                resp = await Session(sess.conn).call(
                    "update_now", {}, timeout=timeout)
                return {"hostname": host, **resp.data}
            except Exception as e:
                return {"hostname": host, "updated": False,
                        "message": f"{type(e).__name__}: {e}"}

        results = await asyncio.gather(*(one(h) for h in hostnames))
        # "nothing to do" outcomes are successes: already current, or a
        # prior swap healthy-pending its restart
        benign = ("up to date", "pending restart")
        return web.json_response({
            "data": list(results),
            "success": all(r.get("updated") or
                           any(b in r.get("message", "") for b in benign)
                           for r in results)})

    async def agent_install_ps1(request):
        """Windows install script (reference: AgentInstallScriptHandler,
        /plus/agent/install/win) — mirrors install.sh: fetch the pyz +
        pinned signer key over pinned TLS; with -Server (and optionally
        -BootstrapToken) it also registers + starts the NT service via
        sc.exe, otherwise it prints the manual run command."""
        base = f"https://{request.host}"
        from cryptography import x509

        from ..utils import mtls as _mtls
        cert_pem = await fsio.aread_bytes(server.certs.server_cert_path)
        fp = _mtls.cert_fingerprint(
            x509.load_pem_x509_certificate(cert_pem))
        script = f"""# pbs-plus-tpu agent install (Windows)
param(
    [string]$Server = "",
    [string]$BootstrapToken = ""
)
$ErrorActionPreference = "Stop"
$Base = "{base}"
$Dest = "$Env:ProgramFiles\\pbs-plus-tpu"
New-Item -ItemType Directory -Force -Path $Dest | Out-Null
# TLS pin: the server certificate fingerprint is baked into this script
$ExpectedFp = "{fp}"
$Handler = [System.Net.Http.HttpClientHandler]::new()
$Handler.ServerCertificateCustomValidationCallback = {{
    param($msg, $cert, $chain, $errors)
    # SHA-256 over the raw DER: works on .NET Framework (PowerShell 5.1)
    # too — GetCertHashString("SHA256") is a Core-only overload
    $sha = [Security.Cryptography.SHA256]::Create()
    $hex = -join ($sha.ComputeHash($cert.GetRawCertData()) |
                  ForEach-Object {{ $_.ToString("x2") }})
    ($hex -eq $ExpectedFp.ToLower())
}}
$Http = [System.Net.Http.HttpClient]::new($Handler)
foreach ($f in @("pyz", "signer.pub")) {{
    $out = Join-Path $Dest ($f -replace "pyz", "pbs-plus-tpu-agent.pyz")
    $bytes = $Http.GetByteArrayAsync("$Base/plus/agent/$f").Result
    [IO.File]::WriteAllBytes($out, $bytes)
}}
Write-Host "installed $Dest\\pbs-plus-tpu-agent.pyz"
if ($Server) {{
    # register as an NT service (mirror of agent/win/service.py install():
    # auto-start + failure restarts), then start it.  New-Service passes
    # $BinPath to CreateService verbatim — PS 5.1's native-arg quoting
    # would mangle sc.exe create's embedded quotes around Program Files.
    $BinPath = "py `"$Dest\\pbs-plus-tpu-agent.pyz`" agent --server $Server" +
               " --bootstrap-url $Base" +
               $(if ($BootstrapToken) {{ " --bootstrap-token $BootstrapToken" }} else {{ "" }})
    New-Service -Name PBSPlusTPUAgent -BinaryPathName $BinPath `
        -StartupType Automatic -DisplayName "PBS Plus TPU Agent" | Out-Null
    sc.exe failure PBSPlusTPUAgent reset= 86400 `
        actions= restart/5000/restart/30000/restart/60000 | Out-Null
    Start-Service PBSPlusTPUAgent
    Write-Host "service PBSPlusTPUAgent registered and started"
}} else {{
    Write-Host "run: py $Dest\\pbs-plus-tpu-agent.pyz agent --server <host>:8008 ``"
    Write-Host "  --bootstrap-url $Base --bootstrap-token <token_id:secret>"
    Write-Host "(re-run with -Server <host>:8008 to register the NT service)"
}}
"""
        return web.Response(text=script,
                            content_type="text/x-powershell")

    async def alert_settings_get(request):
        return web.json_response({"data": server.db.list_alert_settings()})

    async def alert_settings_put(request):
        b = await request.json()
        if not isinstance(b, dict):
            return web.json_response({"error": "want a JSON object"},
                                     status=400)
        for k, v in b.items():
            server.db.put_alert_setting(str(k)[:128], str(v)[:1024])
        return web.json_response({"ok": True})

    async def notifications_list(request):
        """Spooled notifications (newest first)."""
        spool = os.path.join(server.config.state_dir, "notify-spool")
        out = []
        try:
            names = sorted(os.listdir(spool), reverse=True)[:100]
        except OSError:
            names = []
        for n in names:
            try:
                out.append(json.loads(
                    await fsio.aread_text(os.path.join(spool, n))))
            except (OSError, ValueError):
                continue
        return web.json_response({"data": out})

    async def agent_install_sh(request):
        """Self-install script (the agent-binary-download analog —
        reference serves agent binaries/MSI from the server)."""
        host = request.headers.get("Host", "SERVER")
        # Embed the server CA so the artifact download runs over *verified*
        # TLS pinned to this deployment's CA (no -k: an install-time MITM
        # could otherwise substitute a malicious agent before the Ed25519
        # update verification ever gets a chance to run).
        ca_pem = await fsio.aread_text(server.certs.ca_cert_path)
        if not ca_pem.endswith("\n"):     # keep the heredoc terminator on
            ca_pem += "\n"                # its own line for any ca.pem
        script = f"""#!/bin/sh
# pbs-plus-tpu agent installer (server: {host})
set -e
BASE="${{PBS_PLUS_URL:-https://{host}}}"
DEST="${{PBS_PLUS_DEST:-/opt/pbs-plus-tpu}}"
mkdir -p "$DEST"
CA="$DEST/server-ca.pem"
cat > "$CA" <<'PBS_PLUS_CA_EOF'
{ca_pem}PBS_PLUS_CA_EOF
curl -fsS --cacert "$CA" "$BASE/plus/agent/pyz" -o "$DEST/pbs-plus-tpu-agent.pyz"
chmod +x "$DEST/pbs-plus-tpu-agent.pyz"
echo "installed $DEST/pbs-plus-tpu-agent.pyz"
echo "run: python3 $DEST/pbs-plus-tpu-agent.pyz agent \\\\"
echo "  --server <host>:8008 --bootstrap-url $BASE \\\\"
echo "  --bootstrap-token <token_id:secret>"
"""
        return web.Response(text=script, content_type="text/x-shellscript")

    # release-artifact work is singleflighted: a fleet-wide update makes
    # every agent hit these at once, and the pyz build + Ed25519 signing
    # must run once per stampede, not once per agent (reference:
    # web/api/plus.go downloadFlight)
    release_flight = SingleFlight()
    server.release_flight = release_flight          # test/metrics probe

    def _in_executor(fn, *args):
        return asyncio.get_running_loop().run_in_executor(None, fn, *args)

    async def agent_pyz(request):
        """Zipapp of this package — the runnable 'agent binary'."""
        pyz = await release_flight.do(
            "pyz", lambda: _in_executor(_build_agent_pyz,
                                        server.config.state_dir))
        return web.FileResponse(
            pyz, headers={"Content-Disposition":
                          'attachment; filename="pbs-plus-tpu-agent.pyz"'})

    async def agent_version(request):
        """Update metadata the agent Updater polls: version (content
        hash), sha256, Ed25519 signature over the artifact (reference:
        the server's agent version endpoint + signed binary download the
        updater/binswap consumes)."""
        info = await release_flight.do(
            "version", lambda: _in_executor(_agent_release_info, server))
        return web.json_response(info)

    async def agent_signer_pub(request):
        """The release-signing public key (fetched at install time;
        pinned by the agent thereafter)."""
        pub = await release_flight.do(
            "signer", lambda: _in_executor(_signer_keys, server))
        return web.Response(body=pub[1],
                            content_type="application/x-pem-file")

    async def ui_page(request):
        from .ui import DASHBOARD_HTML
        return web.Response(text=DASHBOARD_HTML, content_type="text/html")

    # per-snapshot directory listings, built once per (snapshot,
    # manifest-mtime) and reused across the many per-level requests a
    # tree browser issues (a full entry scan per click would starve the
    # shared executor on big archives)
    _tree_cache: dict[str, tuple[float, dict]] = {}
    _tree_cache_lock = threading.Lock()   # build() runs on executor threads

    async def snapshot_filetree(request):
        """Browse a stored snapshot's tree one level at a time (the
        reference UI's snapshot file browser backing; live-agent browse
        is the separate /d2d/filetree)."""
        from ..pxar import chunkcache
        from ..pxar.datastore import parse_snapshot_ref
        from ..pxar.transfer import SplitReader
        snap = request.query.get("snapshot", "")
        sub = request.query.get("path", "").strip("/")

        def build() -> dict:
            ref = parse_snapshot_ref(snap)
            ds = server.datastore.datastore
            mtime = os.path.getmtime(
                os.path.join(ds.snapshot_dir(ref), ds.MANIFEST))
            with _tree_cache_lock:
                hit = _tree_cache.get(snap)
                if hit is not None and hit[0] == mtime:
                    return hit[1]
            reader = SplitReader.open_snapshot(
                ds, ref, cache=chunkcache.shared_cache())
            bydir: dict[str, list] = {}
            for e in reader.entries():
                if not e.path:
                    continue
                parent, _, name = e.path.rpartition("/")
                bydir.setdefault(parent, []).append(
                    {"name": name, "path": e.path, "kind": e.kind,
                     "size": e.size, "dir": e.is_dir})
            with _tree_cache_lock:
                while len(_tree_cache) >= 4:
                    _tree_cache.pop(next(iter(_tree_cache)))
                _tree_cache[snap] = (mtime, bydir)
            return bydir

        try:
            bydir = await asyncio.get_running_loop().run_in_executor(
                None, build)
        except (FileNotFoundError, ValueError) as e:
            return web.json_response({"error": str(e)}, status=404)
        return web.json_response({"data": bydir.get(sub, [])})

    async def debug_stacks(request):
        """All thread + asyncio task stacks (the pprof goroutine-dump
        analog; reference mounts net/http/pprof on the API mux)."""
        import sys
        import traceback
        lines = ["== threads =="]
        frames = sys._current_frames()
        for t in threading.enumerate():
            lines.append(f"\n-- thread {t.name} "
                         f"(daemon={t.daemon}, ident={t.ident})")
            f = frames.get(t.ident)
            if f is not None:
                lines.extend(x.rstrip() for x in traceback.format_stack(f))
        lines.append("\n== asyncio tasks ==")
        for task in asyncio.all_tasks():
            lines.append(f"\n-- task {task.get_name()} "
                         f"(done={task.done()})")
            for fr in task.get_stack(limit=8):
                lines.extend(x.rstrip() for x in
                             traceback.format_stack(fr, limit=1))
        return web.Response(text="\n".join(lines),
                            content_type="text/plain")

    async def prune_run(request):
        """Retention + GC (reference: PBS prune/GC job analog).  Body:
        {keep_last, keep_daily, keep_weekly, dry_run, gc_grace_s}; empty
        policy falls back to the server's configured one."""
        from .prune import PrunePolicy
        try:
            b = await request.json() if request.can_read_body else {}
            if not isinstance(b, dict):
                raise ValueError("want a JSON object")
            policy = PrunePolicy(
                keep_last=int(b.get("keep_last", 0)),
                keep_daily=int(b.get("keep_daily", 0)),
                keep_weekly=int(b.get("keep_weekly", 0)))
            grace = b.get("gc_grace_s")
            if grace is not None:
                import math
                grace = float(grace)
                if not math.isfinite(grace) or grace < 0:
                    raise ValueError("gc_grace_s must be a finite value "
                                     ">= 0")
        except (ValueError, TypeError) as e:
            return web.json_response({"error": str(e)}, status=400)
        if policy.empty():
            policy = server.prune_policy()
        if policy.empty():
            return web.json_response(
                {"error": "no retention policy (configure prune_keep_* "
                          "or pass keep_last/keep_daily/keep_weekly)"},
                status=400)
        try:
            report = await server.run_prune(
                policy, dry_run=bool(b.get("dry_run", False)),
                gc_grace_s=grace)
        except RuntimeError as e:
            # jobs in flight: the caller should retry after they finish
            return web.json_response({"error": str(e)}, status=409)
        return web.json_response({"data": {
            "removed": report.removed, "kept": report.kept,
            "chunks_removed": report.chunks_removed,
            "bytes_freed": report.bytes_freed,
            "dry_run": report.dry_run}})

    async def snapshot_delete(request):
        from ..pxar.datastore import parse_snapshot_ref
        # tail match: namespaced refs are ns/a/.../type/id/time — more
        # than three segments, parsed (and traversal-checked) as a whole
        snap = request.match_info["snap"]
        try:
            ref = parse_snapshot_ref(snap)
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)
        ds = server.datastore.datastore
        if ref not in ds.list_snapshots(all_namespaces=True):
            return web.json_response({"error": "unknown snapshot"},
                                     status=404)
        # PruneService serializes the delete against a GC mark phase
        # (the service owns the lock, not the Server)
        await server.prune.delete_snapshot(ref)
        return web.json_response({"ok": True})

    app.router.add_get("/api2/json/d2d/sync", sync_list)
    app.router.add_post("/api2/json/d2d/sync", sync_upsert)
    app.router.add_delete("/api2/json/d2d/sync/{id}", sync_delete)
    app.router.add_post("/api2/json/d2d/sync/{id}/run", sync_run)
    app.router.add_get("/api2/json/d2d/sync/{id}/results", sync_results)
    app.router.add_get("/api2/json/d2d/verification", verification_list)
    app.router.add_post("/api2/json/d2d/verification", verification_upsert)
    app.router.add_post("/api2/json/d2d/verification/{id}/run",
                        verification_run)
    app.router.add_delete("/api2/json/d2d/target/{name}", target_delete)
    app.router.add_get("/api2/json/d2d/script", script_list)
    app.router.add_post("/api2/json/d2d/script", script_upsert)
    app.router.add_delete("/api2/json/d2d/script/{name}", script_delete)
    app.router.add_get("/api2/json/d2d/restores", restores_list)
    app.router.add_get("/api2/json/d2d/token", token_list)
    app.router.add_delete("/api2/json/d2d/token/{tid}", token_delete)
    app.router.add_delete("/api2/json/d2d/exclusion/{eid}", exclusion_delete)
    app.router.add_get("/api2/json/d2d/verification/{id}/results",
                       verification_results)
    app.router.add_get("/api2/json/d2d/verification/{id}/export",
                       verification_export)
    app.router.add_get("/api2/json/d2d/verification-aggregate",
                       verification_aggregate)
    app.router.add_get("/api2/json/d2d/backup-export", backup_export_csv)
    app.router.add_post("/api2/json/d2d/push-update", push_update)
    app.router.add_get("/api2/json/d2d/target-status", target_status)
    app.router.add_get("/api2/json/d2d/alert-settings", alert_settings_get)
    app.router.add_post("/api2/json/d2d/alert-settings", alert_settings_put)
    app.router.add_get("/plus/notifications", notifications_list)
    app.router.add_get("/plus/agent/install.sh", agent_install_sh)
    app.router.add_get("/plus/agent/install.ps1", agent_install_ps1)
    app.router.add_get("/plus/agent/pyz", agent_pyz)
    app.router.add_get("/plus/agent/binary", agent_pyz)   # updater alias
    app.router.add_get("/plus/agent/version", agent_version)
    app.router.add_get("/plus/agent/signer.pub", agent_signer_pub)
    app.router.add_get("/plus/ui", ui_page)
    app.router.add_post("/api2/json/d2d/prune", prune_run)
    app.router.add_delete("/api2/json/d2d/snapshots/{snap:.+}",
                          snapshot_delete)
    app.router.add_get("/api2/json/d2d/snapshot-filetree",
                       snapshot_filetree)
    app.router.add_get("/plus/debug/stacks", debug_stacks)
    return app


_pyz_lock = threading.Lock()
_release_cache: dict = {}


def _signer_keys(server) -> tuple[bytes, bytes]:
    """(private_pem, public_pem) of the release-signing key —
    load-or-create Ed25519 under the state dir (reference: the signer
    key whose signatures updater/binswap verify)."""
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import ed25519

    key_p = os.path.join(server.config.state_dir, "signer.key")
    pub_p = key_p + ".pub"
    with _pyz_lock:
        if os.path.exists(key_p):
            # NEVER regenerate while a private key exists — agents pin
            # the public key at install; a new pair would brick fleet
            # auto-update silently.  The pub is derived, not trusted
            # from disk, so a missing/partial .pub self-heals.
            priv = fsio.read_bytes(key_p)
            key = serialization.load_pem_private_key(priv, password=None)
            pub = key.public_key().public_bytes(
                serialization.Encoding.PEM,
                serialization.PublicFormat.SubjectPublicKeyInfo)
            if not os.path.exists(pub_p):
                atomicio.replace_bytes(pub_p, pub)
            return priv, pub
        key = ed25519.Ed25519PrivateKey.generate()
        priv = key.private_bytes(serialization.Encoding.PEM,
                                 serialization.PrivateFormat.PKCS8,
                                 serialization.NoEncryption())
        pub = key.public_key().public_bytes(
            serialization.Encoding.PEM,
            serialization.PublicFormat.SubjectPublicKeyInfo)
        for path, data in ((pub_p, pub), (key_p, priv)):
            # 0o600 from the first byte; priv lands LAST: its presence
            # implies the pub is complete
            atomicio.replace_bytes(path, data, mode_bits=0o600)
        return priv, pub


_RELEASE_TTL_S = 30.0


def _agent_release_info(server) -> dict:
    """{version, sha256, signature} for the current agent artifact.
    Short-TTL cached BEFORE touching the pyz builder — a fleet's version
    polls must not each walk the package tree under the build lock."""
    import hashlib

    from cryptography.hazmat.primitives import serialization

    state = server.config.state_dir
    hit = _release_cache.get(state)
    now = time.monotonic()
    if hit is not None and now - hit[2] < _RELEASE_TTL_S:
        return hit[1]
    pyz = _build_agent_pyz(state)
    mtime = os.path.getmtime(pyz)
    if hit is not None and hit[0] == mtime:
        _release_cache[state] = (mtime, hit[1], now)
        return hit[1]
    data = fsio.read_bytes(pyz)
    digest = hashlib.sha256(data).hexdigest()
    priv_pem, _pub = _signer_keys(server)
    key = serialization.load_pem_private_key(priv_pem, password=None)
    sig = key.sign(data)
    info = {"version": digest[:16], "sha256": digest,
            "signature": sig.hex(), "size": len(data)}
    _release_cache[state] = (mtime, info, now)
    return info


def _build_agent_pyz(state_dir: str) -> str:
    """Build (and cache) a runnable zipapp of this package — the analog
    of the reference's downloadable agent binary.  Rebuilt when the
    package source is newer than the cached artifact.  Serialized: two
    concurrent downloads must not race the stage dir or serve a
    half-written archive."""
    import shutil
    import uuid as _uuid
    import zipapp

    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = os.path.join(state_dir, "agent-dist", "pbs-plus-tpu-agent.pyz")
    with _pyz_lock:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        newest = 0.0
        for dirpath, dirnames, files in os.walk(pkg_dir):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for f in files:
                if not f.endswith(".pyc"):
                    newest = max(newest,
                                 os.path.getmtime(os.path.join(dirpath, f)))
        if os.path.exists(out) and os.path.getmtime(out) >= newest:
            return out
        stage = os.path.join(state_dir, "agent-dist",
                             f"stage-{_uuid.uuid4().hex[:8]}")
        try:
            dst = os.path.join(stage, "pbs_plus_tpu_torch")
            shutil.copytree(pkg_dir, dst, ignore=shutil.ignore_patterns(
                "__pycache__", "*.pyc"))
            with open(os.path.join(stage, "__main__.py"), "w") as f:
                f.write("from pbs_plus_tpu_torch.__main__ import main\n"
                        "import sys\nsys.exit(main())\n")
            tmp = f"{out}.tmp.{_uuid.uuid4().hex[:8]}"
            zipapp.create_archive(stage, tmp,
                                  interpreter="/usr/bin/env python3")
            atomicio.publish_staged(tmp, out)
        finally:
            shutil.rmtree(stage, ignore_errors=True)
        return out


async def start_web(server: "Server", *, host: str = "127.0.0.1",
                    port: int = 0, require_auth: bool = True,
                    ) -> tuple[web.AppRunner, int]:
    # app construction loads the ticket key once, BEFORE the site
    # accepts a single connection — the sanctioned startup-IO case of
    # the blocking rule, not a per-request stall
    # pbslint: disable=no-blocking-in-async-transitive
    app = build_app(server, require_auth=require_auth)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    await site.start()
    bound = site._server.sockets[0].getsockname()[1]
    L.info("web API listening on %s:%d", host, bound)
    return runner, bound
