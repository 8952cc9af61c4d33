"""Operator entrypoint (reference: cmd/operator/main.go:1-73).

A copy of the JAX package's ``operator/__main__.py``, its code byte for
byte. Run it as ``python -m pbs_plus_tpu_torch.operator``."""

import asyncio
import os


async def main() -> None:
    import aiohttp

    from .kube import KubeClient
    from .operator import Operator, OperatorConfig

    async with aiohttp.ClientSession() as http:
        # one-time startup read of the mounted serviceaccount token,
        # before any request is served — the sanctioned startup case
        # pbslint: disable=no-blocking-in-async-transitive
        kube = KubeClient.in_cluster(http)
        op = Operator(kube, OperatorConfig(
            server_url=os.environ["PBS_PLUS_SERVER_URL"],
            bootstrap_url=os.environ["PBS_PLUS_BOOTSTRAP_URL"],
            bootstrap_token=os.environ.get("PBS_PLUS_BOOTSTRAP_TOKEN", ""),
            agent_image=os.environ.get("PBS_PLUS_AGENT_IMAGE",
                                       "pbs-plus-tpu:latest"),
        ))
        if os.environ.get("PBS_PLUS_LEADER_ELECT", "1") != "0":
            from .leader import LeaderElector
            # identity must be unique per replica — a shared fallback
            # would let every replica believe it holds the lease
            ident = os.environ.get("HOSTNAME") or \
                f"{os.uname().nodename}-{os.urandom(3).hex()}"
            elector = LeaderElector(
                kube, lease_name="pbs-plus-tpu-operator", identity=ident)

            async def run_op():
                # a stopped operator must also stop renewing the lease,
                # or standbys never take over (silent reconcile outage)
                try:
                    await op.run(leader=elector)
                finally:
                    elector.stop()
            await asyncio.gather(elector.run(), run_op())
        else:
            await op.run()


if __name__ == "__main__":
    asyncio.run(main())
