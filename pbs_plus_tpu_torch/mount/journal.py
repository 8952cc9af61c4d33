"""The mutation journal: a durable overlay graph of filesystem changes.

Reference: internal/pxarmount/journal.go:14-744 — pebble (LSM) keyspaces
for nodes/edges/whiteouts/xattrs, per-node FNV checksums, an async
single-writer commit loop, orphan-edge GC, and VerifyIntegrity.

Backing store here is sqlite WAL (the image's durable KV; plays the
reference's pebble role).  Schema:

    nodes(id, kind, mode, uid, gid, mtime_ns, size, link_target,
          content_path, base_path, checksum)
    edges(parent_id, name, child_id)        -- overlay directory entries
    whiteouts(parent_id, name)              -- deletions of archive entries
    xattrs(node_id, name, value)

Node id 1 is the overlay root.  ``content_path`` points into the
passthrough dir for copied-up regular files; ``base_path`` remembers the
archive path a node was copied up from (commit-time ref decisions).
Checksums are FNV-1a over the node row (reference: per-node FNV,
journal.go:197-226); VerifyIntegrity re-walks and re-hashes.

A copy of the JAX package's ``mount/journal.py``, its code byte for byte
(it imports only the standard library).
"""

from __future__ import annotations

import os
import sqlite3
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

ROOT_ID = 1

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_M64 = (1 << 64) - 1


def _fnv1a(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _M64
    return h


class JournalError(RuntimeError):
    pass


@dataclass
class Node:
    id: int
    kind: str                  # d | f | l  (dirs, files, symlinks)
    mode: int = 0o644
    uid: int = 0
    gid: int = 0
    mtime_ns: int = 0
    size: int = 0
    link_target: str = ""
    content_path: str = ""     # passthrough-relative path for file content
    base_path: str | None = None   # archive path this was copied up from

    def _checksum_bytes(self) -> bytes:
        return "|".join(str(x) for x in (
            self.id, self.kind, self.mode, self.uid, self.gid,
            self.mtime_ns, self.size, self.link_target, self.content_path,
            self.base_path if self.base_path is not None else "\0",
        )).encode()

    @property
    def checksum(self) -> int:
        c = _fnv1a(self._checksum_bytes())
        return c - (1 << 64) if c >= (1 << 63) else c   # signed for sqlite


class Journal:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._lock = threading.RLock()
        self._init_schema()

    def _init_schema(self) -> None:
        with self._lock, self._conn:
            self._conn.executescript("""
            CREATE TABLE IF NOT EXISTS nodes (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                kind TEXT NOT NULL,
                mode INTEGER NOT NULL DEFAULT 420,
                uid INTEGER NOT NULL DEFAULT 0,
                gid INTEGER NOT NULL DEFAULT 0,
                mtime_ns INTEGER NOT NULL DEFAULT 0,
                size INTEGER NOT NULL DEFAULT 0,
                link_target TEXT NOT NULL DEFAULT '',
                content_path TEXT NOT NULL DEFAULT '',
                base_path TEXT,
                checksum INTEGER NOT NULL
            );
            CREATE TABLE IF NOT EXISTS edges (
                parent_id INTEGER NOT NULL,
                name TEXT NOT NULL,
                child_id INTEGER NOT NULL,
                PRIMARY KEY (parent_id, name)
            );
            CREATE TABLE IF NOT EXISTS whiteouts (
                parent_id INTEGER NOT NULL,
                name TEXT NOT NULL,
                PRIMARY KEY (parent_id, name)
            );
            CREATE TABLE IF NOT EXISTS xattrs (
                node_id INTEGER NOT NULL,
                name TEXT NOT NULL,
                value BLOB NOT NULL,
                PRIMARY KEY (node_id, name)
            );
            """)
            if self.get_node(ROOT_ID) is None:
                self._conn.execute(
                    "INSERT INTO nodes (id, kind, mode, checksum) "
                    "VALUES (?, 'd', 493, ?)",
                    (ROOT_ID, Node(ROOT_ID, "d", 0o755).checksum))

    # -- nodes -------------------------------------------------------------
    def _row_to_node(self, r: sqlite3.Row) -> Node:
        return Node(id=r["id"], kind=r["kind"], mode=r["mode"], uid=r["uid"],
                    gid=r["gid"], mtime_ns=r["mtime_ns"], size=r["size"],
                    link_target=r["link_target"],
                    content_path=r["content_path"], base_path=r["base_path"])

    def get_node(self, node_id: int) -> Optional[Node]:
        with self._lock:
            r = self._conn.execute("SELECT * FROM nodes WHERE id=?",
                                   (node_id,)).fetchone()
        return self._row_to_node(r) if r else None

    def put_node(self, node: Node) -> int:
        with self._lock, self._conn:
            if node.id == 0:
                cur = self._conn.execute(
                    """INSERT INTO nodes (kind,mode,uid,gid,mtime_ns,size,
                       link_target,content_path,base_path,checksum)
                       VALUES (?,?,?,?,?,?,?,?,?,0)""",
                    (node.kind, node.mode, node.uid, node.gid, node.mtime_ns,
                     node.size, node.link_target, node.content_path,
                     node.base_path))
                node.id = cur.lastrowid
            self._conn.execute(
                """UPDATE nodes SET kind=?,mode=?,uid=?,gid=?,mtime_ns=?,
                   size=?,link_target=?,content_path=?,base_path=?,checksum=?
                   WHERE id=?""",
                (node.kind, node.mode, node.uid, node.gid, node.mtime_ns,
                 node.size, node.link_target, node.content_path,
                 node.base_path, node.checksum, node.id))
        return node.id

    # -- edges / whiteouts -------------------------------------------------
    def set_edge(self, parent_id: int, name: str, child_id: int) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT OR REPLACE INTO edges VALUES (?,?,?)",
                (parent_id, name, child_id))
            self._conn.execute(
                "DELETE FROM whiteouts WHERE parent_id=? AND name=?",
                (parent_id, name))

    def get_edge(self, parent_id: int, name: str) -> Optional[int]:
        with self._lock:
            r = self._conn.execute(
                "SELECT child_id FROM edges WHERE parent_id=? AND name=?",
                (parent_id, name)).fetchone()
        return r["child_id"] if r else None

    def del_edge(self, parent_id: int, name: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "DELETE FROM edges WHERE parent_id=? AND name=?",
                (parent_id, name))

    def edges(self, parent_id: int) -> list[tuple[str, int]]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT name, child_id FROM edges WHERE parent_id=? "
                "ORDER BY name", (parent_id,)).fetchall()
        return [(r["name"], r["child_id"]) for r in rows]

    def add_whiteout(self, parent_id: int, name: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT OR REPLACE INTO whiteouts VALUES (?,?)",
                (parent_id, name))
            self._conn.execute(
                "DELETE FROM edges WHERE parent_id=? AND name=?",
                (parent_id, name))

    def is_whiteout(self, parent_id: int, name: str) -> bool:
        with self._lock:
            r = self._conn.execute(
                "SELECT 1 FROM whiteouts WHERE parent_id=? AND name=?",
                (parent_id, name)).fetchone()
        return r is not None

    def whiteouts(self, parent_id: int) -> set[str]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT name FROM whiteouts WHERE parent_id=?",
                (parent_id,)).fetchall()
        return {r["name"] for r in rows}

    # -- xattrs ------------------------------------------------------------
    def set_xattr(self, node_id: int, name: str, value: bytes) -> None:
        with self._lock, self._conn:
            self._conn.execute("INSERT OR REPLACE INTO xattrs VALUES (?,?,?)",
                               (node_id, name, value))

    def del_xattr(self, node_id: int, name: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "DELETE FROM xattrs WHERE node_id=? AND name=?",
                (node_id, name))

    def xattrs(self, node_id: int) -> dict[str, bytes]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT name, value FROM xattrs WHERE node_id=?",
                (node_id,)).fetchall()
        return {r["name"]: r["value"] for r in rows}

    def xattr(self, node_id: int, name: str) -> bytes | None:
        """Single-name lookup — getxattr is a hot kernel path (probe +
        fetch per call); fetching the whole dict would double the IO."""
        with self._lock:
            r = self._conn.execute(
                "SELECT value FROM xattrs WHERE node_id=? AND name=?",
                (node_id, name)).fetchone()
        return r["value"] if r else None

    # -- maintenance -------------------------------------------------------
    def sync(self) -> None:
        with self._lock:
            self._conn.execute("PRAGMA wal_checkpoint(FULL)")

    def clear(self) -> None:
        """Wipe the overlay (post-commit; reference: journal Clear+Sync)."""
        with self._lock, self._conn:
            for t in ("edges", "whiteouts", "xattrs"):
                self._conn.execute(f"DELETE FROM {t}")
            self._conn.execute("DELETE FROM nodes WHERE id != ?", (ROOT_ID,))
        self.sync()

    def verify_integrity(self) -> list[str]:
        """Re-hash nodes + check edge targets exist (reference:
        VerifyIntegrity + orphan-edge GC detection).  Returns problems."""
        problems: list[str] = []
        with self._lock:
            nodes = {r["id"]: r for r in
                     self._conn.execute("SELECT * FROM nodes")}
            for r in nodes.values():
                n = self._row_to_node(r)
                if n.checksum != r["checksum"]:
                    problems.append(f"node {n.id}: checksum mismatch")
            for r in self._conn.execute("SELECT * FROM edges"):
                if r["child_id"] not in nodes:
                    problems.append(
                        f"edge {r['parent_id']}/{r['name']}: orphan child "
                        f"{r['child_id']}")
                if r["parent_id"] not in nodes:
                    problems.append(
                        f"edge {r['parent_id']}/{r['name']}: orphan parent")
        return problems

    def gc_orphan_edges(self) -> int:
        with self._lock, self._conn:
            cur = self._conn.execute(
                "DELETE FROM edges WHERE child_id NOT IN (SELECT id FROM nodes)"
                " OR parent_id NOT IN (SELECT id FROM nodes)")
            return cur.rowcount

    def stats(self) -> dict:
        with self._lock:
            out = {}
            for t in ("nodes", "edges", "whiteouts", "xattrs"):
                out[t] = self._conn.execute(
                    f"SELECT COUNT(*) c FROM {t}").fetchone()["c"]
        return out

    def close(self) -> None:
        self._conn.close()
