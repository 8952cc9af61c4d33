"""Cartridge inventory store: which tape holds which datasets/snapshots.

Reference: internal/server/mtf/store/ (~2.3k LoC of sqlc-generated
queries over its own sqlite DB) — cartridge records, dataset→cartridge
mapping, scan history.  Re-designed as one small sqlite schema with the
same capability surface: register cartridges seen in the changer, map
converted datasets to the snapshot they landed in, answer "which tape do
I need for X".

A copy of the JAX package's ``tapeio/inventory.py``, its code byte for
byte."""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from typing import Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cartridges (
    volume_tag TEXT PRIMARY KEY,
    pool TEXT NOT NULL DEFAULT '',
    location TEXT NOT NULL DEFAULT '',       -- slot:<n> | drive:<n> | offsite
    write_protected INTEGER NOT NULL DEFAULT 0,
    first_seen REAL NOT NULL,
    last_seen REAL NOT NULL,
    notes TEXT NOT NULL DEFAULT ''
);
CREATE TABLE IF NOT EXISTS datasets (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    volume_tag TEXT NOT NULL REFERENCES cartridges(volume_tag),
    name TEXT NOT NULL,                      -- MTF data-set name
    file_mark INTEGER NOT NULL DEFAULT -1,   -- tape position
    snapshot TEXT NOT NULL DEFAULT '',       -- converted destination
    bytes INTEGER NOT NULL DEFAULT 0,
    converted_at REAL,
    meta TEXT NOT NULL DEFAULT '{}',
    UNIQUE(volume_tag, name)
);
"""


class CartridgeInventory:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.executescript(_SCHEMA)
        self._lock = threading.RLock()

    def close(self) -> None:
        self._conn.close()

    # -- cartridges ---------------------------------------------------------
    def upsert_cartridge(self, volume_tag: str, *, pool: str = "",
                         location: str = "",
                         write_protected: bool = False,
                         notes: str = "") -> None:
        now = time.time()
        with self._lock, self._conn:
            self._conn.execute(
                """INSERT INTO cartridges (volume_tag,pool,location,
                   write_protected,first_seen,last_seen,notes)
                   VALUES (?,?,?,?,?,?,?)
                   ON CONFLICT(volume_tag) DO UPDATE SET
                     pool=CASE WHEN excluded.pool!='' THEN excluded.pool
                               ELSE pool END,
                     location=CASE WHEN excluded.location!=''
                              THEN excluded.location ELSE location END,
                     write_protected=excluded.write_protected,
                     last_seen=excluded.last_seen,
                     notes=CASE WHEN excluded.notes!='' THEN excluded.notes
                           ELSE notes END""",
                (volume_tag, pool, location, int(write_protected),
                 now, now, notes))

    def sync_from_changer(self, inventory) -> int:
        """Register every tagged cartridge a changer inventory reports
        (changer.Inventory); returns how many were seen."""
        n = 0
        for slot in [*inventory.slots, *inventory.drives]:
            if slot.full and slot.volume_tag:
                loc = f"{'drive' if slot.kind == 'drive' else 'slot'}:" \
                      f"{slot.index}"
                self.upsert_cartridge(slot.volume_tag, location=loc)
                n += 1
        return n

    def get_cartridge(self, volume_tag: str) -> Optional[dict]:
        with self._lock:
            r = self._conn.execute(
                "SELECT * FROM cartridges WHERE volume_tag=?",
                (volume_tag,)).fetchone()
        return dict(r) if r else None

    def list_cartridges(self, *, pool: str = "") -> list[dict]:
        q = "SELECT * FROM cartridges"
        args: tuple = ()
        if pool:
            q += " WHERE pool=?"
            args = (pool,)
        with self._lock:
            return [dict(r) for r in self._conn.execute(q, args)]

    def set_location(self, volume_tag: str, location: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE cartridges SET location=?, last_seen=? "
                "WHERE volume_tag=?", (location, time.time(), volume_tag))

    # -- datasets -----------------------------------------------------------
    def record_dataset(self, volume_tag: str, name: str, *,
                       file_mark: int = -1, snapshot: str = "",
                       bytes_: int = 0, meta: dict | None = None) -> None:
        self.upsert_cartridge(volume_tag)
        with self._lock, self._conn:
            self._conn.execute(
                """INSERT INTO datasets (volume_tag,name,file_mark,snapshot,
                   bytes,converted_at,meta) VALUES (?,?,?,?,?,?,?)
                   ON CONFLICT(volume_tag,name) DO UPDATE SET
                     file_mark=CASE WHEN excluded.file_mark>=0
                              THEN excluded.file_mark ELSE file_mark END,
                     bytes=CASE WHEN excluded.bytes>0
                              THEN excluded.bytes ELSE bytes END,
                     meta=CASE WHEN excluded.meta!='{}'
                              THEN excluded.meta ELSE meta END,
                     snapshot=CASE WHEN excluded.snapshot!=''
                              THEN excluded.snapshot ELSE snapshot END,
                     converted_at=CASE WHEN excluded.snapshot!=''
                              THEN excluded.converted_at
                              ELSE converted_at END""",
                (volume_tag, name, file_mark, snapshot, bytes_,
                 time.time() if snapshot else None,
                 json.dumps(meta or {})))

    def datasets_on(self, volume_tag: str) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._conn.execute(
                "SELECT * FROM datasets WHERE volume_tag=? "
                "ORDER BY file_mark", (volume_tag,))]

    def find_dataset(self, name: str) -> list[dict]:
        """Which cartridge(s) hold this dataset — the operator's
        'which tape do I need' query."""
        with self._lock:
            return [dict(r) for r in self._conn.execute(
                """SELECT d.*, c.location, c.pool FROM datasets d
                   JOIN cartridges c ON c.volume_tag = d.volume_tag
                   WHERE d.name = ?""", (name,))]

    def unconverted(self) -> list[dict]:
        """Datasets seen on tape but not yet converted to a snapshot."""
        with self._lock:
            return [dict(r) for r in self._conn.execute(
                "SELECT * FROM datasets WHERE snapshot='' "
                "ORDER BY volume_tag, file_mark")]
