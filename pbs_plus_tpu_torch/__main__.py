"""Command line of the port: ``python -m pbs_plus_tpu_torch server``,
``agent``, ``agent-job``, ``sidecar``, ``index-shard``,
``dryrun-multichip``, ``mount``, ``commit``, ``job``, ``signer`` and
``mtfprobe``.

    python -m pbs_plus_tpu_torch server --datastore /srv/ds \
        --state-dir /srv/state --cert-dir /srv/certs --print-token \
        --device cuda

runs the backup server daemon: the aRPC listener agents connect to
(``--arpc-port``, 8008), the web API (``--web-port``, 8017; routes of
``server/web.py``), the scheduler, the notification spool and the
alert scanner.  Backups cut (K1), digest (K2) and probe (K3) on
``--device``; without a card ``--device cuda`` exits nonzero naming
CUDA (``--device cpu`` runs the plain versions).  The flags are the JAX
package's ``server`` flags plus ``--device``; ``--chunker`` defaults to
``cuda`` (the reference's to ``cpu``, which the port does not serve),
and the log (to stderr at INFO, and to ``--log-file`` where given) is
the reference's: one JSON object a line with its dedup window
(``utils/log.py``).  ``--print-token`` prints a bootstrap token and
an API token (``token_id:secret_hex``).

    python -m pbs_plus_tpu_torch agent --server 127.0.0.1:8008 \
        --state-dir /var/lib/agent --bootstrap-url http://127.0.0.1:8017 \
        --bootstrap-token <token_id:secret_hex>

runs the backup agent: on first start it enrols over
``POST /plus/agent/bootstrap`` (a CSR signed with the bootstrap token),
then keeps its control session open.  Each backup or restore runs in a
``python -m pbs_plus_tpu_torch agent-job`` child
(``--job-isolation subprocess``, the default) or as a task in the agent
(``task``).  The flags are the JAX package's ``agent`` flags, plus
``--snapshots``: ``auto`` (the default, the reference's behaviour) takes
a btrfs, zfs or LVM snapshot or an fsfreeze quiesce of the source's
filesystem where one is available; ``direct`` reads the live tree and
touches no filesystem setting (tests, and machines shared with other
work).

    python -m pbs_plus_tpu_torch sidecar --listen 127.0.0.1:18900 \\
        --chunk-avg 4194304 --device cuda

serves the dedup sidecar on the card (``--device cpu`` runs the plain
versions on the CPU; ``cuda`` without a card raises).  A backup server
reaches it through a job row with ``chunker = "sidecar:127.0.0.1:18900"``.

    python -m pbs_plus_tpu_torch index-shard --shard-id s0 --port 9001 \\
        --spill-dir /srv/idx/s0 --snapshot /srv/idx/s0.snap --device cuda

runs one node of the distributed dedup index (the JAX package's flags,
ready line and stdin protocol); a server reaches it through
``PBS_PLUS_DIST_INDEX_SHARDS="s0=127.0.0.1:9001,s1=127.0.0.1:9002"``.

    python -m pbs_plus_tpu_torch dryrun-multichip --devices 8 --device cuda

runs the multi-device step and sequence-parallel chunking once at tiny
shapes against the single-device path, over ``cuda:0..7``, or over
``cuda:0`` repeated where fewer cards are visible; it prints a JSON
summary.

    python -m pbs_plus_tpu_torch mount --store /srv/ds \
        --snapshot host/web/2026-01-01T00:00:00Z --mount-state /srv/m1 \
        --socket /srv/m1/ctl.sock --mountpoint /mnt/web --device cuda
    python -m pbs_plus_tpu_torch commit --socket /srv/m1/ctl.sock

serves a snapshot as a mutable mount (``--pbs-url`` for a PBS server
instead of ``--store``; no ``--snapshot`` for an empty one) and commits
it as a new snapshot: the changed files are cut (K1), digested (K2),
probed against the store's index (K3) and re-verified (K2) on the card.
The flags are the JAX package's ``mount``/``commit`` flags, plus
``--device``.

    python -m pbs_plus_tpu_torch job backup --socket /srv/state/job.sock \
        --id nightly
    python -m pbs_plus_tpu_torch job status --socket /srv/state/job.sock \
        --id nightly
    python -m pbs_plus_tpu_torch job list --socket /srv/state/job.sock

queues a backup job, or reads one job's row or the list of jobs, over
a running server's job socket (``<state_dir>/job.sock`` of a port
``Server`` or a JAX one: the wire is the same); it prints the answer as
JSON and exits 1 where the answer is not ok.  ``restore`` queues a
restore (``--target``, ``--snapshot``, ``--destination``,
``--subpath``).

    python -m pbs_plus_tpu_torch signer keygen --key release.pem
    python -m pbs_plus_tpu_torch signer sign --key release.pem --file agent.pyz
    python -m pbs_plus_tpu_torch signer verify --key release.pem.pub \
        --file agent.pyz

mints an Ed25519 release key (``<key>`` and ``<key>.pub``), signs an
agent artifact (``<file>.sig``; Ed25519 or ECDSA P-256 keys) and checks
a signature as the agent's updater does (``agent/updater.py``), exiting
1 on a bad one.  Keys and signatures are the JAX package's bytes: either
package's ``signer`` verifies what the other signed.

    python -m pbs_plus_tpu_torch mtfprobe -v media.bkf

walks MTF/BKF media (``tapeio/mtf.py``) and prints its directories,
files and content bytes (``-v`` lists each entry); media that end
without an ESET block exit 1 unless ``--lenient``.  Output and exit
codes are the JAX package's ``mtfprobe``'s.  A medium goes into a store
with ``tapeio.convert_mtf_to_snapshot`` over a ``LocalStore`` or
``PBSStore`` session, on the store's device.
"""

from __future__ import annotations

import argparse
import os
import sys

from .parallel.dist_index import add_shard_arguments

def _log_to_stderr():
    """The package's log at INFO on stderr, JSON lines with the dedup
    window, as the reference's log module sets up its own at import."""
    from .utils import log
    return log.install()


def _cmd_server(args: argparse.Namespace) -> int:
    """Twin of the JAX package's ``cli._cmd_server``: the server's
    device is ``--device``."""
    import asyncio

    from .server.notifications import (AlertScanner, BatchTracker,
                                       file_spool_sink)
    from .server.store import Server, ServerConfig
    from .server.web import start_web
    from .utils.device import CudaUnavailableError

    _log_to_stderr()
    if args.log_file:
        from .utils.log import add_rotating_file
        add_rotating_file(args.log_file)

    async def main():
        try:
            server = Server(ServerConfig(
                state_dir=args.state_dir, cert_dir=args.cert_dir,
                datastore_dir=args.datastore, arpc_host=args.host,
                arpc_port=args.arpc_port, chunker=args.chunker,
                chunk_avg=args.chunk_avg,
                datastore_format=args.datastore_format,
                pbs_url=args.pbs_url, pbs_datastore=args.pbs_datastore,
                pbs_token=args.pbs_token, pbs_namespace=args.pbs_namespace,
                pbs_fingerprint=args.pbs_fingerprint,
                pbs_auth_key_path=args.pbs_auth_key,
                pbs_csrf_key_path=args.pbs_csrf_key,
                pbs_auth_allowed_users=args.pbs_auth_users,
                prune_keep_last=args.prune_keep_last,
                prune_keep_daily=args.prune_keep_daily,
                prune_keep_weekly=args.prune_keep_weekly,
                prune_schedule=args.prune_schedule), device=args.device)
        except CudaUnavailableError as e:
            raise SystemExit(f"server: {e}")
        from .server.notify_templates import TemplateSet
        templates = TemplateSet(os.path.join(args.state_dir, "templates"))
        sink = file_spool_sink(os.path.join(args.state_dir, "notify-spool"))
        server.notifications = BatchTracker(sink=sink, templates=templates)
        scanner = AlertScanner(server, sink, templates=templates)
        await server.start()
        runner, web_port = await start_web(
            server, host=args.host, port=args.web_port,
            require_auth=not args.no_auth)
        scan_task = asyncio.create_task(scanner.run())
        print(f"pbs-plus-tpu server: aRPC :{server.config.arpc_port}, "
              f"web :{web_port}", flush=True)
        if args.print_token:
            tid, secret = server.issue_bootstrap_token(ttl_s=24 * 3600)
            print(f"bootstrap token: {tid}:{secret.hex()}", flush=True)
            aid, asecret = server.issue_api_token()
            print(f"api token:       {aid}:{asecret.hex()}", flush=True)
        stop = asyncio.Event()
        try:
            await stop.wait()
        finally:
            scanner.stop()
            scan_task.cancel()
            await runner.cleanup()
            await server.stop()
    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        pass
    return 0


def _cmd_agent(args: argparse.Namespace) -> int:
    """Twin of the JAX package's ``cli._cmd_agent``."""
    import asyncio

    import aiohttp

    from .agent.lifecycle import AgentConfig, AgentLifecycle
    from .agent.snapshots import SnapshotManager
    from .arpc import TlsClientConfig
    from .utils import fsio, mtls

    _log_to_stderr()
    state = os.path.abspath(args.state_dir)
    os.makedirs(state, exist_ok=True)
    cert_p = os.path.join(state, "agent.pem")
    key_p = os.path.join(state, "agent.key")
    ca_p = os.path.join(state, "ca.pem")

    async def bootstrap():
        key = mtls.generate_private_key()
        csr = mtls.make_csr(key, args.hostname)
        tid, sec = args.bootstrap_token.split(":", 1)
        async with aiohttp.ClientSession() as http:
            r = await http.post(
                f"{args.bootstrap_url}/plus/agent/bootstrap",
                json={"hostname": args.hostname, "csr": csr.decode(),
                      "token_id": tid, "token_secret": sec})
            if r.status != 200:
                raise SystemExit(f"bootstrap failed: {await r.text()}")
            body = await r.json()
        await fsio.awrite_text(cert_p, body["cert"])
        await fsio.awrite_text(ca_p, body["ca"])
        await asyncio.to_thread(fsio.write_private_bytes, key_p,
                                mtls.key_pem(key))
        print("bootstrapped: certificate stored", flush=True)

    async def main():
        if not os.path.exists(cert_p):
            if not args.bootstrap_token or not args.bootstrap_url:
                raise SystemExit(
                    "no certificate; pass --bootstrap-url and "
                    "--bootstrap-token for first-time setup")
            await bootstrap()
        host, port = args.server.rsplit(":", 1)
        agent = AgentLifecycle(AgentConfig(
            hostname=args.hostname, server_host=host, server_port=int(port),
            tls=TlsClientConfig(cert_p, key_p, ca_p),
            job_isolation=args.job_isolation),
            snapshot_manager=SnapshotManager(
                prefer_direct=args.snapshots == "direct"))
        await agent.run()
    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        pass
    return 0


def _cmd_agent_job(args: argparse.Namespace) -> int:
    from .agent.jobproc import run_child
    _log_to_stderr()
    return run_child(args.config)


def _cmd_signer(args: argparse.Namespace) -> int:
    """Sign/verify agent artifacts (reference: cmd/signer — mints the
    ECDSA/Ed25519 signatures the updater verifies)."""
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import ed25519

    from .agent.updater import verify_signature
    from .utils import fsio

    if args.action == "keygen":
        key = ed25519.Ed25519PrivateKey.generate()
        priv = key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption())
        pub = key.public_key().public_bytes(
            serialization.Encoding.PEM,
            serialization.PublicFormat.SubjectPublicKeyInfo)
        fsio.write_private_bytes(args.key, priv)
        fsio.write_bytes(f"{args.key}.pub", pub)
        print(f"wrote {args.key} and {args.key}.pub")
        return 0
    if not args.file:
        print(f"signer {args.action} requires --file", flush=True)
        return 2
    data = fsio.read_bytes(args.file)
    if args.action == "sign":
        key = serialization.load_pem_private_key(
            fsio.read_bytes(args.key), password=None)
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import ec
        if isinstance(key, ed25519.Ed25519PrivateKey):
            sig = key.sign(data)
        elif isinstance(key, ec.EllipticCurvePrivateKey):
            sig = key.sign(data, ec.ECDSA(hashes.SHA256()))
        else:
            print("unsupported key type", flush=True)
            return 2
        fsio.write_bytes(f"{args.file}.sig", sig)
        print(f"wrote {args.file}.sig ({len(sig)} bytes)")
        return 0
    # verify
    sig = fsio.read_bytes(args.sig or f"{args.file}.sig")
    ok = verify_signature(data, sig, fsio.read_bytes(args.key))
    print("OK" if ok else "BAD SIGNATURE")
    return 0 if ok else 1


def _cmd_sidecar(args: argparse.Namespace) -> int:
    from .chunker.spec import ChunkerParams
    from .sidecar import serve_sidecar

    server, port, svc = serve_sidecar(
        args.listen, params=ChunkerParams(avg_size=args.chunk_avg),
        device=args.device)
    print(f"sidecar listening on port {port} (device={svc.device})", flush=True)
    try:
        server.wait_for_termination()
    except KeyboardInterrupt:
        server.stop(grace=5)
    return 0


def _cmd_index_shard(args: argparse.Namespace) -> int:
    from .parallel.dist_index import serve_shard
    return serve_shard(args)


def _cmd_dryrun(args: argparse.Namespace) -> int:
    import json

    from .parallel.dryrun import dryrun_multichip
    print(json.dumps(dryrun_multichip(args.devices, device=args.device)),
          flush=True)
    return 0


def _cmd_mount(args: argparse.Namespace) -> int:
    """Twin of the JAX package's ``cli._cmd_mount``: the store, the
    commit engine and the sessions run on ``--device``."""
    import asyncio

    from .chunker import ChunkerParams
    from .mount import ArchiveView, CommitEngine, Journal, MutableFS
    from .mount.control import MountControl
    from .pxar import LocalStore
    from .pxar.datastore import parse_snapshot_ref

    if not args.store and not args.pbs_url:
        raise SystemExit("mount: one of --store / --pbs-url is required")
    if args.pbs_url and not args.pbs_datastore:
        raise SystemExit("mount: --pbs-datastore is required with --pbs-url")

    async def main():
        params = ChunkerParams(avg_size=args.chunk_avg)
        if args.pbs_url:
            # mount + commit straight against a PBS server (the
            # reference's primary pxar-mount workflow: serve a PBS
            # snapshot mutable, commit re-snapshots to the same PBS)
            from .pxar.pbsstore import PBSConfig, PBSStore
            store = PBSStore(PBSConfig(
                base_url=args.pbs_url, datastore=args.pbs_datastore,
                auth_token=args.pbs_token, namespace=args.pbs_namespace,
                fingerprint=args.pbs_fingerprint), params,
                device=args.device)
        else:
            store = LocalStore(args.store, params,
                               pbs_format=args.datastore_format == "pbs",
                               device=args.device)
        previous = None
        if args.snapshot:
            from .pxar import chunkcache
            previous = parse_snapshot_ref(args.snapshot)
            view = ArchiveView(store.open_snapshot(
                previous, cache=chunkcache.shared_cache()))
        else:
            view = ArchiveView(None)     # init mode: empty archive
        state = os.path.abspath(args.mount_state)
        journal = Journal(os.path.join(state, "journal.db"))
        fs = MutableFS(view, journal, os.path.join(state, "passthrough"))
        bid = args.backup_id or (previous.backup_id if previous else "mount")
        engine = CommitEngine(fs, store, backup_id=bid, previous=previous,
                              device=args.device)
        ctl = MountControl(engine, args.socket)
        fuse = None
        try:
            await ctl.start()
            if args.mountpoint:
                from .mount.fusefs import FuseMount
                try:
                    fuse = FuseMount(fs, args.mountpoint)
                    await asyncio.get_running_loop().run_in_executor(
                        None, fuse.mount)
                except (OSError, TimeoutError, RuntimeError) as e:
                    raise SystemExit(f"kernel FUSE mount failed: {e}")
                print(f"kernel mount at {args.mountpoint}", flush=True)
            print(f"mounted "
                  f"{'(init mode)' if not args.snapshot else args.snapshot}"
                  f"; control socket {args.socket}", flush=True)
            stop = asyncio.Event()
            import signal
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    loop.add_signal_handler(sig, stop.set)
                except (NotImplementedError, RuntimeError):
                    pass
            await stop.wait()       # SIGTERM/SIGINT land here → finally runs
        finally:
            if fuse is not None:
                await asyncio.get_running_loop().run_in_executor(
                    None, fuse.unmount)
            await ctl.stop()
    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        pass
    return 0


def _cmd_commit(args: argparse.Namespace) -> int:
    import asyncio

    from .mount.control import commit_via_socket

    async def main():
        snap = await commit_via_socket(args.socket, timeout=args.timeout)
        print(snap)
    asyncio.run(main())
    return 0


def _cmd_job(args: argparse.Namespace) -> int:
    """One-shot job mutation over the server's unix socket (the JAX
    package's ``job`` command)."""
    import asyncio
    import json as _json

    from .server.jobrpc import call_job_rpc

    if args.action == "backup":
        req = {"op": "backup_queue", "job_id": args.id}
    elif args.action == "restore":
        req = {"op": "restore_queue", "target": args.target,
               "snapshot": args.snapshot, "destination": args.destination,
               "subpath": args.subpath}
    elif args.action == "status":
        req = {"op": "status", "job_id": args.id}
    else:
        req = {"op": "list"}
    resp = asyncio.run(call_job_rpc(args.socket, req))
    print(_json.dumps(resp, indent=1))
    return 0 if resp.get("ok") else 1


def _cmd_mtfprobe(args: argparse.Namespace) -> int:
    """Tape/BKF diagnostics (reference: cmd/mtfprobe/main.go:13-40)."""
    from .tapeio.mtf import MTFError, MTFReader
    with open(args.file, "rb") as f:
        rdr = MTFReader(f, strict=not args.lenient)
        n_files = n_dirs = total = 0
        try:
            for e in rdr.entries():
                if args.verbose:
                    print(f"{e.kind:4s} {e.path}"
                          + (f"  ({e.size} bytes)" if e.kind == "file"
                             else ""))
                if e.kind == "file":
                    n_files += 1
                    total += e.size
                else:
                    n_dirs += 1
        except MTFError as e:
            print(f"MTF error: {e}")
            return 1
    print(f"{args.file}: {n_dirs} dirs, {n_files} files, "
          f"{total} content bytes")
    return 0


def build_parser() -> argparse.ArgumentParser:
    """Every command's parser (the operator's pod ``args`` parse here)."""
    ap = argparse.ArgumentParser(prog="python -m pbs_plus_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("server", help="run the backup server daemon")
    # the JAX package's server flags, plus --device
    s.add_argument("--state-dir", default="/var/lib/pbs-plus-tpu")
    s.add_argument("--cert-dir", default="/etc/pbs-plus-tpu/certs")
    s.add_argument("--datastore", required=True)
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--arpc-port", type=int, default=8008)
    s.add_argument("--web-port", type=int, default=8017)
    s.add_argument("--chunker", default="cuda")
    s.add_argument("--chunk-avg", type=int, default=4 << 20)
    s.add_argument("--datastore-format", default="tpxd",
                   choices=("tpxd", "pbs"),
                   help="on-disk snapshot layout: native tpxd, or pbs "
                        "(stock-PBS DataBlob chunks + .didx indexes)")
    s.add_argument("--no-auth", action="store_true")
    s.add_argument("--print-token", action="store_true",
                   help="mint + print a bootstrap token at startup")
    s.add_argument("--pbs-url", default="",
                   help="push-target PBS base URL (store='pbs' jobs)")
    s.add_argument("--pbs-datastore", default="")
    s.add_argument("--pbs-token", default="",
                   help="PBSAPIToken user@realm!name:secret")
    s.add_argument("--pbs-namespace", default="")
    s.add_argument("--pbs-fingerprint", default="")
    s.add_argument("--pbs-auth-key", default="",
                   help="PBS ticket-signing key (e.g. /etc/proxmox-backup/"
                        "authkey.key); enables PBS-cookie auth on the web API")
    s.add_argument("--pbs-csrf-key", default="",
                   help="PBS CSRF secret (/etc/proxmox-backup/csrf.key); "
                        "required for cookie-authenticated write requests")
    s.add_argument("--pbs-auth-users", default="",
                   help="CSV of PBS userids granted sidecar access via "
                        "cookie (default root@pam; '*' = any PBS user)")
    s.add_argument("--prune-keep-last", type=int, default=0)
    s.add_argument("--prune-keep-daily", type=int, default=0)
    s.add_argument("--prune-keep-weekly", type=int, default=0)
    s.add_argument("--prune-schedule", default="",
                   help="calendar expr for scheduled prune+GC")
    s.add_argument("--log-file", default="",
                   help="size-rotated log file (50 MiB x 5)")
    s.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    s.set_defaults(fn=_cmd_server)
    a = sub.add_parser("agent", help="run the backup agent")
    a.add_argument("--hostname", default=os.uname().nodename)
    a.add_argument("--server", required=True, help="aRPC host:port")
    a.add_argument("--state-dir", default="/var/lib/pbs-plus-tpu-agent")
    a.add_argument("--bootstrap-url", default="",
                   help="http(s)://server:web-port for first-time bootstrap")
    a.add_argument("--bootstrap-token", default="", help="token_id:secret_hex")
    a.add_argument("--job-isolation", choices=["task", "subprocess"],
                   default="subprocess",
                   help="run jobs as forked child processes (default) or "
                        "in-process asyncio tasks")
    a.add_argument("--snapshots", choices=["auto", "direct"], default="auto",
                   help="auto: a CoW snapshot or fsfreeze of the source's "
                        "filesystem where available; direct: read the live "
                        "tree")
    a.set_defaults(fn=_cmd_agent)
    aj = sub.add_parser("agent-job",
                        help="(internal) forked job child entrypoint")
    aj.add_argument("--config", required=True,
                    help="one-time handoff file from the agent daemon")
    aj.set_defaults(fn=_cmd_agent_job)
    d = sub.add_parser("sidecar", help="run the dedup sidecar")
    d.add_argument("--listen", default="127.0.0.1:18900")
    d.add_argument("--chunk-avg", type=int, default=4 << 20)
    d.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    d.set_defaults(fn=_cmd_sidecar)
    x = sub.add_parser("index-shard",
                       help="run one node of the distributed dedup index")
    add_shard_arguments(x)
    x.set_defaults(fn=_cmd_index_shard)
    m = sub.add_parser("dryrun-multichip",
                       help="run the multi-device step once at tiny shapes")
    m.add_argument("--devices", type=int, default=8)
    m.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    m.set_defaults(fn=_cmd_dryrun)
    mt = sub.add_parser("mount", help="serve a mutable archive mount")
    # the JAX package's mount flags, plus --device
    mt.add_argument("--store", default="",
                    help="local datastore dir (or use --pbs-url)")
    mt.add_argument("--snapshot", default="",
                    help="[ns/<n>/...]type/id/time (omit for init mode)")
    mt.add_argument("--pbs-url", default="",
                    help="mount against a PBS server instead of --store")
    mt.add_argument("--pbs-datastore", default="")
    mt.add_argument("--pbs-token", default="")
    mt.add_argument("--pbs-namespace", default="")
    mt.add_argument("--pbs-fingerprint", default="")
    mt.add_argument("--mount-state", required=True)
    mt.add_argument("--socket", required=True)
    mt.add_argument("--backup-id", default="")
    mt.add_argument("--chunk-avg", type=int, default=4 << 20)
    mt.add_argument("--datastore-format", default="tpxd",
                    choices=("tpxd", "pbs"))
    mt.add_argument("--mountpoint", default="",
                    help="also expose the mount via kernel FUSE here")
    mt.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    mt.set_defaults(fn=_cmd_mount)
    c = sub.add_parser("commit", help="commit a mounted archive")
    c.add_argument("--socket", required=True)
    c.add_argument("--timeout", type=float, default=600.0)
    c.set_defaults(fn=_cmd_commit)
    j = sub.add_parser("job", help="one-shot job mutation (unix socket)")
    j.add_argument("action", choices=["backup", "restore", "status", "list"])
    j.add_argument("--socket", required=True,
                   help="<state-dir>/job.sock of the running server")
    j.add_argument("--id", default="", help="backup job id")
    j.add_argument("--target", default="")
    j.add_argument("--snapshot", default="")
    j.add_argument("--destination", default="")
    j.add_argument("--subpath", default="")
    j.set_defaults(fn=_cmd_job)
    sg = sub.add_parser("signer", help="sign/verify agent artifacts")
    sg.add_argument("action", choices=["keygen", "sign", "verify"])
    sg.add_argument("--key", required=True,
                    help="private key (sign/keygen) or public key (verify)")
    sg.add_argument("--file", default="", help="artifact to sign/verify")
    sg.add_argument("--sig", default="", help="signature path (verify)")
    sg.set_defaults(fn=_cmd_signer)
    mp = sub.add_parser("mtfprobe", help="MTF/BKF media diagnostics")
    mp.add_argument("file")
    mp.add_argument("-v", "--verbose", action="store_true")
    mp.add_argument("--lenient", action="store_true",
                    help="tolerate truncation (salvage mode)")
    mp.set_defaults(fn=_cmd_mtfprobe)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
