"""Command line of the port: ``python -m pbs_plus_tpu_torch sidecar``.

    python -m pbs_plus_tpu_torch sidecar --listen 127.0.0.1:18900 \\
        --chunk-avg 4194304 --device cuda

serves the dedup sidecar on the card (``--device cpu`` runs the plain
versions on the CPU; ``cuda`` without a card raises).  A backup server
reaches it through a job row with ``chunker = "sidecar:127.0.0.1:18900"``.
"""

from __future__ import annotations

import argparse
import sys


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


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pbs_plus_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("sidecar", help="run the dedup sidecar")
    d.add_argument("--listen", default="127.0.0.1:18900")
    d.add_argument("--chunk-avg", type=int, default=4 << 20)
    d.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    d.set_defaults(fn=_cmd_sidecar)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
