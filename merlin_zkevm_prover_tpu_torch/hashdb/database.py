"""State database: node/program stores with caches and write-behind batching.

Mirrors the reference `Database` (src/hashdb/database.cpp): a durable
backend (sqlite3 standing in for PostgreSQL — same SQL shape, zero-egress
environment), an LRU node cache (`DatabaseMTCache` analog), and a
MultiWrite buffer drained by a sender thread (database.cpp:91, 737-751,
1279-1291).  Keys are 4-felt node hashes; values 12-felt node payloads.
"""

from __future__ import annotations

import collections
import sqlite3
import threading
from typing import Dict, List, Optional, Tuple


def key_str(key: Tuple[int, ...]) -> str:
    return "".join(f"{int(v):016x}" for v in key)


class LruCache:
    def __init__(self, max_entries: int = 1 << 20):
        self.max_entries = max_entries
        self.data: "collections.OrderedDict" = collections.OrderedDict()
        self.lock = threading.Lock()

    def get(self, k):
        with self.lock:
            if k in self.data:
                self.data.move_to_end(k)
                return self.data[k]
        return None

    def put(self, k, v):
        with self.lock:
            self.data[k] = v
            self.data.move_to_end(k)
            while len(self.data) > self.max_entries:
                self.data.popitem(last=False)


class AssociativeCache:
    """Fixed-size direct-mapped cache (DatabaseMTAssociativeCache analog)."""

    def __init__(self, log2_size: int = 16):
        self.size = 1 << log2_size
        self.keys: List[Optional[Tuple]] = [None] * self.size
        self.vals: List[Optional[List[int]]] = [None] * self.size
        self.lock = threading.Lock()

    def _slot(self, k) -> int:
        return hash(k) & (self.size - 1)

    def get(self, k):
        i = self._slot(k)
        with self.lock:
            if self.keys[i] == k:
                return self.vals[i]
        return None

    def put(self, k, v):
        i = self._slot(k)
        with self.lock:
            self.keys[i] = k
            self.vals[i] = v


class MultiWrite:
    """Write-behind buffer flushed in batches by the sender thread."""

    def __init__(self):
        self.nodes: Dict[str, List[int]] = {}
        self.programs: Dict[str, bytes] = {}
        self.lock = threading.Lock()

    def add_node(self, k: str, v: List[int]):
        with self.lock:
            self.nodes[k] = v

    def add_program(self, k: str, v: bytes):
        with self.lock:
            self.programs[k] = v

    def drain(self):
        with self.lock:
            nodes, self.nodes = self.nodes, {}
            programs, self.programs = self.programs, {}
        return nodes, programs


class Database:
    """Node + program store.  backend: ':memory:' or a sqlite file path."""

    def __init__(self, backend: str = ":memory:", use_cache: bool = True,
                 use_assoc_cache: bool = False, sender_thread: bool = False):
        # one shared connection serialized by a lock: sqlite ':memory:' DBs
        # are per-connection, and gRPC handlers run on arbitrary threads
        self._conn_obj = sqlite3.connect(backend, check_same_thread=False)
        self._conn_lock = threading.RLock()
        self.backend = backend
        self.cache = LruCache() if use_cache else None
        self.assoc = AssociativeCache() if use_assoc_cache else None
        self.multi = MultiWrite()
        self._stop = threading.Event()
        self._flush_req = threading.Event()
        self._flushed_id = 0
        self._pending_id = 0
        self._id_lock = threading.Lock()
        self._init_schema()
        self._sender = None
        if sender_thread:
            self._sender = threading.Thread(
                target=self._sender_loop, daemon=True
            )
            self._sender.start()

    def _init_schema(self):
        with self._conn_lock:
            c = self._conn_obj
            c.execute("CREATE TABLE IF NOT EXISTS nodes "
                      "(hash TEXT PRIMARY KEY, data TEXT)")
            c.execute("CREATE TABLE IF NOT EXISTS programs "
                      "(hash TEXT PRIMARY KEY, data BLOB)")
            c.commit()

    # ------------------------------------------------------------------
    def read_node(self, key: Tuple[int, ...]) -> Optional[List[int]]:
        ks = key_str(key)
        if self.assoc is not None:
            v = self.assoc.get(ks)
            if v is not None:
                return v
        if self.cache is not None:
            v = self.cache.get(ks)
            if v is not None:
                return v
        with self.multi.lock:
            if ks in self.multi.nodes:
                return self.multi.nodes[ks]
        with self._conn_lock:
            row = self._conn_obj.execute(
                "SELECT data FROM nodes WHERE hash = ?", (ks,)
            ).fetchone()
        if row is None:
            return None
        v = [int(x) for x in row[0].split(":")]
        self._fill_caches(ks, v)
        return v

    def _fill_caches(self, ks, v):
        if self.cache is not None:
            self.cache.put(ks, v)
        if self.assoc is not None:
            self.assoc.put(ks, v)

    def write_node(self, key: Tuple[int, ...], value: List[int],
                   persistent: bool = True):
        ks = key_str(key)
        self._fill_caches(ks, list(value))
        if persistent:
            self.multi.add_node(ks, list(value))
            with self._id_lock:
                self._pending_id += 1
            if self._sender:
                self._flush_req.set()
            else:
                self.flush()

    # -- program (contract bytecode) storage --
    def get_program(self, key: Tuple[int, ...]) -> Optional[bytes]:
        ks = key_str(key)
        with self.multi.lock:
            if ks in self.multi.programs:
                return self.multi.programs[ks]
        with self._conn_lock:
            row = self._conn_obj.execute(
                "SELECT data FROM programs WHERE hash = ?", (ks,)
            ).fetchone()
        return bytes(row[0]) if row else None

    def set_program(self, key: Tuple[int, ...], data: bytes,
                    persistent: bool = True):
        ks = key_str(key)
        if persistent:
            self.multi.add_program(ks, bytes(data))
            if self._sender:
                self._flush_req.set()
            else:
                self.flush()

    # ------------------------------------------------------------------
    def flush(self) -> int:
        """Drain the MultiWrite buffer into the backend; returns flush id."""
        nodes, programs = self.multi.drain()
        if nodes or programs:
            with self._conn_lock:
                c = self._conn_obj
                c.executemany(
                    "INSERT OR REPLACE INTO nodes VALUES (?, ?)",
                    [(k, ":".join(str(x) for x in v))
                     for k, v in nodes.items()],
                )
                c.executemany(
                    "INSERT OR REPLACE INTO programs VALUES (?, ?)",
                    list(programs.items()),
                )
                c.commit()
        with self._id_lock:
            self._flushed_id = self._pending_id
            return self._flushed_id

    def get_flush_status(self):
        with self._id_lock:
            return {"stored_flush_id": self._flushed_id,
                    "pending_flush_id": self._pending_id}

    def _sender_loop(self):
        while not self._stop.is_set():
            self._flush_req.wait(timeout=0.05)
            self._flush_req.clear()
            self.flush()
        self.flush()

    def close(self):
        self._stop.set()
        if self._sender:
            self._flush_req.set()
            self._sender.join(timeout=2)
