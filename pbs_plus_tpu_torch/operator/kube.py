"""Minimal Kubernetes API client (aiohttp, service-account auth).

A copy of the JAX package's ``operator/kube.py``, its code byte for
byte."""

from __future__ import annotations

import json
import os
import ssl
from typing import Any, AsyncIterator, Optional

from ..utils import fsio

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubeError(RuntimeError):
    def __init__(self, status: int, body: str):
        super().__init__(f"kube api {status}: {body[:300]}")
        self.status = status


class KubeClient:
    def __init__(self, http, base_url: str, *, token: str = "",
                 namespace: str = "default",
                 ssl_ctx: ssl.SSLContext | bool | None = None):
        self.http = http
        self.base = base_url.rstrip("/")
        self.token = token
        self.namespace = namespace
        self.ssl = ssl_ctx

    @classmethod
    def in_cluster(cls, http) -> "KubeClient":
        host = os.environ["KUBERNETES_SERVICE_HOST"]
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        token = fsio.read_text(os.path.join(SA_DIR, "token"))
        ns = fsio.read_text(os.path.join(SA_DIR, "namespace")).strip()
        ctx = ssl.create_default_context(
            cafile=os.path.join(SA_DIR, "ca.crt"))
        return cls(http, f"https://{host}:{port}", token=token,
                   namespace=ns, ssl_ctx=ctx)

    def _headers(self) -> dict[str, str]:
        h = {"Accept": "application/json",
             "Content-Type": "application/json"}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    async def _req(self, method: str, path: str, *, body: Any = None,
                   params: dict | None = None) -> Any:
        kw: dict = {"headers": self._headers(), "params": params or {}}
        if self.ssl is not None:
            kw["ssl"] = self.ssl
        if body is not None:
            kw["json"] = body
        async with self.http.request(method, f"{self.base}{path}", **kw) as r:
            text = await r.text()
            if r.status >= 400:
                raise KubeError(r.status, text)
            return json.loads(text) if text else None

    # -- coordination.k8s.io Leases (leader election) ----------------------
    async def get_lease(self, name: str,
                        namespace: str | None = None) -> Optional[dict]:
        ns = namespace or self.namespace
        try:
            return await self._req(
                "GET",
                f"/apis/coordination.k8s.io/v1/namespaces/{ns}/leases/{name}")
        except KubeError as e:
            if e.status == 404:
                return None
            raise

    async def create_lease(self, spec: dict,
                           namespace: str | None = None) -> dict:
        ns = namespace or self.namespace
        return await self._req(
            "POST", f"/apis/coordination.k8s.io/v1/namespaces/{ns}/leases",
            body=spec)

    async def update_lease(self, name: str, spec: dict,
                           namespace: str | None = None) -> dict:
        ns = namespace or self.namespace
        return await self._req(
            "PUT",
            f"/apis/coordination.k8s.io/v1/namespaces/{ns}/leases/{name}",
            body=spec)

    # -- typed helpers -----------------------------------------------------
    async def list_pvcs(self, namespace: str | None = None) -> list[dict]:
        ns = namespace or self.namespace
        out = await self._req(
            "GET", f"/api/v1/namespaces/{ns}/persistentvolumeclaims")
        return out.get("items", [])

    async def get_pod(self, name: str, namespace: str | None = None) -> Optional[dict]:
        ns = namespace or self.namespace
        try:
            return await self._req("GET", f"/api/v1/namespaces/{ns}/pods/{name}")
        except KubeError as e:
            if e.status == 404:
                return None
            raise

    async def create_pod(self, spec: dict, namespace: str | None = None) -> dict:
        ns = namespace or self.namespace
        return await self._req("POST", f"/api/v1/namespaces/{ns}/pods",
                               body=spec)

    async def delete_pod(self, name: str, namespace: str | None = None) -> None:
        ns = namespace or self.namespace
        try:
            await self._req("DELETE", f"/api/v1/namespaces/{ns}/pods/{name}")
        except KubeError as e:
            if e.status != 404:
                raise

    async def create_volume_snapshot(self, spec: dict,
                                     namespace: str | None = None) -> dict:
        ns = namespace or self.namespace
        return await self._req(
            "POST",
            f"/apis/snapshot.storage.k8s.io/v1/namespaces/{ns}/volumesnapshots",
            body=spec)

    async def get_volume_snapshot(self, name: str,
                                  namespace: str | None = None) -> Optional[dict]:
        ns = namespace or self.namespace
        try:
            return await self._req(
                "GET",
                f"/apis/snapshot.storage.k8s.io/v1/namespaces/{ns}/"
                f"volumesnapshots/{name}")
        except KubeError as e:
            if e.status == 404:
                return None
            raise

    async def delete_volume_snapshot(self, name: str,
                                     namespace: str | None = None) -> None:
        ns = namespace or self.namespace
        try:
            await self._req(
                "DELETE",
                f"/apis/snapshot.storage.k8s.io/v1/namespaces/{ns}/"
                f"volumesnapshots/{name}")
        except KubeError as e:
            if e.status != 404:
                raise

    async def create_pvc(self, spec: dict, namespace: str | None = None) -> dict:
        ns = namespace or self.namespace
        return await self._req(
            "POST", f"/api/v1/namespaces/{ns}/persistentvolumeclaims",
            body=spec)

    async def delete_pvc(self, name: str, namespace: str | None = None) -> None:
        ns = namespace or self.namespace
        try:
            await self._req(
                "DELETE",
                f"/api/v1/namespaces/{ns}/persistentvolumeclaims/{name}")
        except KubeError as e:
            if e.status != 404:
                raise
