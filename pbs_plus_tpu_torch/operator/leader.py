"""Lease-based leader election for the operator.

Reference: cmd/operator/main.go:1-73 — the reference operator takes
--leader-elect and only the lease holder reconciles, so N replicas are
safe.  Standard coordination.k8s.io/v1 Lease protocol: acquire when the
lease is absent/expired/ours, renew at ``renew_every_s``, step down by
letting it expire.  Times use RFC3339 micro timestamps like
client-go.

A copy of the JAX package's ``operator/leader.py``, its code byte for
byte apart from its logger: ``utils/log.L`` becomes a ``logging``
logger."""

from __future__ import annotations

import asyncio
import datetime as dt
import logging

from .kube import KubeClient, KubeError

L = logging.getLogger(__name__)


def _now() -> dt.datetime:
    return dt.datetime.now(dt.timezone.utc)


def _fmt(t: dt.datetime) -> str:
    return t.strftime("%Y-%m-%dT%H:%M:%S.%f") + "Z"


def _parse(s: str) -> dt.datetime:
    return dt.datetime.strptime(s.rstrip("Z")[:26], "%Y-%m-%dT%H:%M:%S.%f"
                                ).replace(tzinfo=dt.timezone.utc)


class LeaderElector:
    def __init__(self, kube: KubeClient, *, lease_name: str,
                 identity: str, lease_duration_s: float = 15.0,
                 renew_every_s: float = 5.0):
        self.kube = kube
        self.lease_name = lease_name
        self.identity = identity
        self.lease_duration_s = lease_duration_s
        self.renew_every_s = renew_every_s
        self.is_leader = False
        self._stop = asyncio.Event()

    def _spec(self, acquisitions: int,
              acquire_time: str | None = None) -> dict:
        """``acquire_time`` preserved on renewals — only a genuine
        acquisition/takeover stamps a new one (client-go semantics)."""
        now = _fmt(_now())
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": self.lease_name},
            "spec": {
                "holderIdentity": self.identity,
                "leaseDurationSeconds": int(self.lease_duration_s),
                "acquireTime": acquire_time or now,
                "renewTime": now,
                "leaseTransitions": acquisitions,
            },
        }

    async def try_acquire_or_renew(self) -> bool:
        """One protocol step; returns current leadership."""
        lease = await self.kube.get_lease(self.lease_name)
        if lease is None:
            try:
                await self.kube.create_lease(self._spec(0))
                self.is_leader = True
                L.info("leader election: acquired %s", self.lease_name)
            except KubeError as e:
                if e.status != 409:      # lost the creation race
                    raise
                self.is_leader = False
            return self.is_leader

        spec = lease.get("spec", {})
        holder = spec.get("holderIdentity", "")
        renew = spec.get("renewTime") or spec.get("acquireTime") or ""
        expired = True
        if renew:
            try:
                age = (_now() - _parse(renew)).total_seconds()
                expired = age > float(spec.get("leaseDurationSeconds",
                                               self.lease_duration_s))
            except ValueError:
                expired = True

        if holder == self.identity or expired or not holder:
            transitions = int(spec.get("leaseTransitions", 0))
            renewal = holder == self.identity
            if not renewal:
                transitions += 1
            new = self._spec(
                transitions,
                acquire_time=spec.get("acquireTime") if renewal else None)
            new["metadata"] = lease.get("metadata", new["metadata"])
            try:
                await self.kube.update_lease(self.lease_name, new)
                if not self.is_leader:
                    L.info("leader election: %s %s",
                           "renewed" if holder == self.identity
                           else "took over", self.lease_name)
                self.is_leader = True
            except KubeError as e:
                if e.status not in (409,):
                    raise
                self.is_leader = False
        else:
            if self.is_leader:
                L.warning("leader election: lost %s to %s",
                          self.lease_name, holder)
            self.is_leader = False
        return self.is_leader

    async def run(self) -> None:
        while not self._stop.is_set():
            try:
                await self.try_acquire_or_renew()
            except Exception as e:
                L.warning("leader election step failed: %s", e)
                self.is_leader = False
            try:
                await asyncio.wait_for(self._stop.wait(),
                                       self.renew_every_s)
            except asyncio.TimeoutError:
                pass

    def stop(self) -> None:
        self._stop.set()
