"""The reconcile loop: annotated PVC → agent pod (snapshot-clone for RWO).

Reference: internal/operator/operator.go:50-246 (PVC watch loop, reconcile)
+ pod_manager.go:43-267 (agent pod spec) + snapshot_manager.go:43-247
(RWO: VolumeSnapshot → restored PVC → pod, readiness waits, cleanup).

A copy of the JAX package's ``operator/operator.py``, its code byte for
byte apart from its logger: ``utils/log.L`` becomes a ``logging``
logger. The agent pod's ``args`` parse with the port's ``agent`` command
(``python -m pbs_plus_tpu_torch agent``).
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field

from .kube import KubeClient

L = logging.getLogger(__name__)

ANNOTATION = "pbs-plus.io/backup"
SCHEDULE_ANNOTATION = "pbs-plus.io/schedule"
MANAGED_LABEL = "app.kubernetes.io/managed-by"
MANAGED_VALUE = "pbs-plus-tpu-operator"


@dataclass
class OperatorConfig:
    server_url: str                        # aRPC server for the agent pods
    bootstrap_url: str                     # web API for bootstrap
    agent_image: str = "pbs-plus-tpu-agent:latest"
    bootstrap_token: str = ""
    poll_interval_s: float = 30.0
    snapshot_class: str = ""               # "" = cluster default


@dataclass
class ReconcileResult:
    created_pods: list[str] = field(default_factory=list)
    created_snapshots: list[str] = field(default_factory=list)
    cleaned: list[str] = field(default_factory=list)
    skipped: list[str] = field(default_factory=list)


class Operator:
    def __init__(self, kube: KubeClient, config: OperatorConfig):
        self.kube = kube
        self.config = config
        self._stop = asyncio.Event()

    # -- specs -------------------------------------------------------------
    def _pod_name(self, pvc_name: str) -> str:
        return f"pbs-agent-{pvc_name}"[:63]

    def agent_pod_spec(self, pvc: dict, mount_pvc_name: str) -> dict:
        name = pvc["metadata"]["name"]
        return {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {
                "name": self._pod_name(name),
                "labels": {MANAGED_LABEL: MANAGED_VALUE,
                           "pbs-plus.io/pvc": name},
            },
            "spec": {
                "restartPolicy": "OnFailure",
                "containers": [{
                    "name": "agent",
                    "image": self.config.agent_image,
                    "args": ["agent",
                             "--hostname", f"pvc-{name}",
                             "--server", self.config.server_url,
                             "--bootstrap-url", self.config.bootstrap_url,
                             "--bootstrap-token", self.config.bootstrap_token,
                             "--state-dir", "/state"],
                    "volumeMounts": [
                        {"name": "data", "mountPath": "/data",
                         "readOnly": True},
                        {"name": "state", "mountPath": "/state"},
                    ],
                }],
                "volumes": [
                    {"name": "data",
                     "persistentVolumeClaim": {"claimName": mount_pvc_name,
                                               "readOnly": True}},
                    {"name": "state", "emptyDir": {}},
                ],
            },
        }

    def snapshot_spec(self, pvc: dict) -> dict:
        name = pvc["metadata"]["name"]
        spec: dict = {
            "apiVersion": "snapshot.storage.k8s.io/v1",
            "kind": "VolumeSnapshot",
            "metadata": {"name": f"pbs-snap-{name}"[:63],
                         "labels": {MANAGED_LABEL: MANAGED_VALUE}},
            "spec": {"source": {"persistentVolumeClaimName": name}},
        }
        if self.config.snapshot_class:
            spec["spec"]["volumeSnapshotClassName"] = self.config.snapshot_class
        return spec

    def clone_pvc_spec(self, pvc: dict, snap_name: str) -> dict:
        name = pvc["metadata"]["name"]
        size = pvc["spec"]["resources"]["requests"]["storage"]
        return {
            "apiVersion": "v1", "kind": "PersistentVolumeClaim",
            "metadata": {"name": f"pbs-clone-{name}"[:63],
                         "labels": {MANAGED_LABEL: MANAGED_VALUE}},
            "spec": {
                "accessModes": ["ReadWriteOnce"],
                "dataSource": {"name": snap_name, "kind": "VolumeSnapshot",
                               "apiGroup": "snapshot.storage.k8s.io"},
                "resources": {"requests": {"storage": size}},
            },
        }

    # -- reconcile ---------------------------------------------------------
    @staticmethod
    def _wants_backup(pvc: dict) -> bool:
        ann = pvc.get("metadata", {}).get("annotations", {}) or {}
        return str(ann.get(ANNOTATION, "")).lower() in ("true", "1", "yes")

    @staticmethod
    def _is_rwo(pvc: dict) -> bool:
        modes = pvc.get("spec", {}).get("accessModes", [])
        return modes == ["ReadWriteOnce"]

    async def reconcile(self) -> ReconcileResult:
        res = ReconcileResult()
        pvcs = await self.kube.list_pvcs()
        wanted = {p["metadata"]["name"]: p for p in pvcs
                  if self._wants_backup(p)}
        for name, pvc in wanted.items():
            pod_name = self._pod_name(name)
            existing = await self.kube.get_pod(pod_name)
            if existing is not None:
                phase = existing.get("status", {}).get("phase", "")
                if phase == "Succeeded":
                    # backup round done → clean the pod (+ clone artifacts)
                    await self.kube.delete_pod(pod_name)
                    await self._cleanup_clone(name)
                    res.cleaned.append(pod_name)
                else:
                    res.skipped.append(pod_name)
                continue
            if self._is_rwo(pvc):
                # RWO: snapshot → clone → pod on the clone
                snap = self.snapshot_spec(pvc)
                snap_name = snap["metadata"]["name"]
                if await self.kube.get_volume_snapshot(snap_name) is None:
                    await self.kube.create_volume_snapshot(snap)
                    res.created_snapshots.append(snap_name)
                got = await self.kube.get_volume_snapshot(snap_name)
                ready = (got or {}).get("status", {}).get("readyToUse", False)
                if not ready:
                    res.skipped.append(f"{snap_name} (snapshot not ready)")
                    continue
                clone = self.clone_pvc_spec(pvc, snap_name)
                try:
                    await self.kube.create_pvc(clone)
                except Exception as e:
                    # isolate the failure to THIS pvc: one broken clone
                    # (quota, RBAC, transport timeout) must not starve
                    # the rest of the reconcile round
                    if getattr(e, "status", None) == 409:
                        L.debug("create_pvc %s: already exists",
                                clone["metadata"]["name"])
                    else:
                        L.warning("create_pvc %s failed: %s",
                                  clone["metadata"]["name"], e)
                        res.skipped.append(f"{name} (clone create failed)")
                        continue
                await self.kube.create_pod(
                    self.agent_pod_spec(pvc, clone["metadata"]["name"]))
            else:
                await self.kube.create_pod(self.agent_pod_spec(pvc, name))
            res.created_pods.append(pod_name)
        return res

    async def _cleanup_clone(self, pvc_name: str) -> None:
        await self.kube.delete_pvc(f"pbs-clone-{pvc_name}"[:63])
        await self.kube.delete_volume_snapshot(f"pbs-snap-{pvc_name}"[:63])

    async def run(self, *, leader=None) -> None:
        """``leader`` (operator.leader.LeaderElector) gates reconciling:
        non-leaders idle (reference: --leader-elect,
        cmd/operator/main.go:1-73)."""
        while not self._stop.is_set():
            try:
                if leader is not None and not leader.is_leader:
                    await asyncio.sleep(0)     # idle replica
                else:
                    res = await self.reconcile()
                    if res.created_pods or res.cleaned:
                        L.info("operator: +%d pods, -%d cleaned, %d skipped",
                               len(res.created_pods), len(res.cleaned),
                               len(res.skipped))
            except Exception:
                L.exception("reconcile failed")
            try:
                await asyncio.wait_for(self._stop.wait(),
                                       self.config.poll_interval_s)
            except asyncio.TimeoutError:
                pass

    def stop(self) -> None:
        self._stop.set()
