"""Per-batch state tracking (reference src/hashdb/state_manager.hpp).

Tracks sub-roots written during a batch so uncommitted state can be
purged or promoted on flush; gives the executor consistent
per-transaction state views.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class TxState:
    old_root: Tuple[int, ...] = (0, 0, 0, 0)
    new_root: Tuple[int, ...] = (0, 0, 0, 0)
    writes: Dict[str, List[int]] = field(default_factory=dict)


@dataclass
class BatchState:
    old_root: Tuple[int, ...] = (0, 0, 0, 0)
    current_root: Tuple[int, ...] = (0, 0, 0, 0)
    txs: List[TxState] = field(default_factory=list)


class StateManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._batches: Dict[str, BatchState] = {}

    def set_old_state_root(self, batch_uuid: str, root: Tuple[int, ...]):
        with self._lock:
            b = self._batches.setdefault(batch_uuid, BatchState())
            if not b.txs:
                b.old_root = tuple(root)
            b.current_root = tuple(root)

    def begin_tx(self, batch_uuid: str):
        with self._lock:
            b = self._batches.setdefault(batch_uuid, BatchState())
            b.txs.append(TxState(old_root=b.current_root))

    def write(self, batch_uuid: str, tx: int, key: str, value: List[int]):
        with self._lock:
            b = self._batches.setdefault(batch_uuid, BatchState())
            while len(b.txs) <= tx:
                b.txs.append(TxState(old_root=b.current_root))
            b.txs[tx].writes[key] = list(value)

    def set_new_state_root(self, batch_uuid: str, tx: int,
                           root: Tuple[int, ...]):
        with self._lock:
            b = self._batches.setdefault(batch_uuid, BatchState())
            while len(b.txs) <= tx:
                b.txs.append(TxState(old_root=b.current_root))
            b.txs[tx].new_root = tuple(root)
            b.current_root = tuple(root)

    def flush(self, batch_uuid: str, db) -> int:
        """Promote a batch's writes into the database and drop the batch."""
        with self._lock:
            b = self._batches.pop(batch_uuid, None)
        if b is None:
            return db.flush()
        for tx in b.txs:
            for ks, v in tx.writes.items():
                db.multi.add_node(ks, v)
        return db.flush()

    def purge(self, batch_uuid: str):
        with self._lock:
            self._batches.pop(batch_uuid, None)

    def get_batch(self, batch_uuid: str) -> Optional[BatchState]:
        with self._lock:
            return self._batches.get(batch_uuid)
