"""Command line of the port: ``python -m pbs_plus_tpu_torch sidecar``,
``index-shard``, ``dryrun-multichip``, ``mount``, ``commit`` and
``job``.

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
JSON and exits 1 where the answer is not ok.  ``restore`` is accepted
and a port server answers that the restore job is not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys

from .parallel.dist_index import add_shard_arguments


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


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pbs_plus_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
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
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
