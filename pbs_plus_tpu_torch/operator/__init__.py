"""Kubernetes operator: back up annotated PVCs with ephemeral agent pods.

Reference: internal/operator + cmd/operator (~950 LoC, SURVEY §2.7) —
PVC informer watching for the ``pbs-plus.io/backup`` annotation → create
an agent pod mounting the PVC (pod_manager.go:43-267); RWO volumes go
through a VolumeSnapshot → restored-PVC flow with readiness waits +
cleanup (snapshot_manager.go:43-247); leader election + metrics in the
binary.

This build talks to the Kubernetes REST API directly over aiohttp
(in-cluster service-account auth; no kube client library in the image) —
the reconcile logic is identical and the API surface is faked in tests.
Deployment manifests: deploy/kubernetes/operator.yaml.

A copy of the JAX package's ``operator/__init__.py``, its code byte for
byte.
"""

from .operator import Operator, OperatorConfig
from .kube import KubeClient

__all__ = ["Operator", "OperatorConfig", "KubeClient"]
