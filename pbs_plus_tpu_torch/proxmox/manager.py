"""PBS management API client: API-token lifecycle + datastore info.

Reference capability: internal/proxmox/cli/refresh_token.go:91-250 and
cli/datastore.go:21 — the reference shells out to
``proxmox-backup-manager`` to mint/refresh the API token it uses against
PBS and to read datastore facts.  This build talks to the PBS HTTP API
directly (SURVEY §2.9: "thin PBS API client"), reusing the synchronous
HTTP/fingerprint machinery from pxar.pbsstore:

    POST   /api2/json/access/users/{userid}/token/{tokenname}
    DELETE /api2/json/access/users/{userid}/token/{tokenname}
    GET    /api2/json/admin/datastore/{store}/status
    GET    /api2/json/admin/datastore          (list)
    GET    /api2/json/version

Auth for these calls is a PBS API token with sufficient privileges (or
a ticket); the mock PBS in tests/mock_pbs.py implements the same
endpoints as the executable contract.

A copy of the JAX package's ``proxmox/manager.py``, its code byte for
byte. It runs over the port's ``pxar/pbsstore._PBSHttp``."""

from __future__ import annotations

from dataclasses import dataclass

from ..pxar.pbsstore import PBSConfig, PBSError, _PBSHttp


@dataclass
class TokenInfo:
    tokenid: str                   # user@realm!name
    value: str                     # the secret (only returned at create)


class PBSManagerClient:
    def __init__(self, cfg: PBSConfig):
        self.cfg = cfg
        self._http = _PBSHttp(cfg)

    def close(self) -> None:
        self._http.close()

    # -- token lifecycle (refresh_token.go analog) -------------------------
    def create_api_token(self, userid: str, name: str, *,
                         comment: str = "") -> TokenInfo:
        data = self._http.call(
            "POST", f"/api2/json/access/users/{userid}/token/{name}",
            json_body={"comment": comment} if comment else {})
        return TokenInfo(tokenid=data["tokenid"], value=data["value"])

    def delete_api_token(self, userid: str, name: str) -> None:
        self._http.call(
            "DELETE", f"/api2/json/access/users/{userid}/token/{name}")

    def refresh_api_token(self, userid: str, name: str) -> TokenInfo:
        """Delete-if-exists + recreate — the reference's refresh flow."""
        try:
            self.delete_api_token(userid, name)
        except PBSError as e:
            if e.status != 404:
                raise
        return self.create_api_token(userid, name)

    # -- datastore facts (datastore.go analog) -----------------------------
    def datastore_status(self, store: str | None = None) -> dict:
        store = store or self.cfg.datastore
        return self._http.call(
            "GET", f"/api2/json/admin/datastore/{store}/status")

    def list_datastores(self) -> list[dict]:
        return self._http.call("GET", "/api2/json/admin/datastore") or []

    def version(self) -> dict:
        return self._http.call("GET", "/api2/json/version")
