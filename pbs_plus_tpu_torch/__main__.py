"""Command line of the port: ``python -m pbs_plus_tpu_torch sidecar``,
``index-shard`` and ``dryrun-multichip``.

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
"""

from __future__ import annotations

import argparse
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
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
