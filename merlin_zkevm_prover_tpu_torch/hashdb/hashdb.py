"""HashDB facade (reference service/hashdb/hashdb_interface.hpp:13-30).

The interface the executor programs against: set/get over the SMT,
program (bytecode) storage, loadDB bulk loads, flush control.  Local
implementation here; the gRPC remote twin lives in service/hashdb_service.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .database import Database
from .smt import Smt, SmtGetResult, SmtSetResult
from .state_manager import StateManager


class HashDB:
    def __init__(self, backend: str = ":memory:", **db_kwargs):
        self.db = Database(backend, **db_kwargs)
        self.smt = Smt()
        self.state_manager = StateManager()

    # -- SMT state --
    def set(self, batch_uuid: str, tx: int, old_root, key, value: int,
            persistence: str = "database") -> SmtSetResult:
        return self.smt.set(self.db, old_root, key, value)

    def get(self, root, key) -> SmtGetResult:
        return self.smt.get(self.db, root, key)

    # -- program (contract bytecode) --
    def set_program(self, key, data: bytes, persistent: bool = True):
        self.db.set_program(tuple(key), data, persistent)

    def get_program(self, key) -> Optional[bytes]:
        return self.db.get_program(tuple(key))

    # -- bulk --
    def load_db(self, nodes: Dict[Tuple[int, ...], List[int]],
                persistent: bool = True):
        for k, v in nodes.items():
            self.db.write_node(tuple(k), list(v), persistent)

    def load_program_db(self, programs: Dict[Tuple[int, ...], bytes],
                        persistent: bool = True):
        for k, v in programs.items():
            self.db.set_program(tuple(k), v, persistent)

    # -- flush control --
    def flush(self, batch_uuid: str = "") -> int:
        if batch_uuid:
            return self.state_manager.flush(batch_uuid, self.db)
        return self.db.flush()

    def semi_flush(self, batch_uuid: str, new_root, persistence: str):
        self.state_manager.set_new_state_root(
            batch_uuid, 0, tuple(new_root)
        )

    def get_flush_status(self):
        return self.db.get_flush_status()

    def purge(self, batch_uuid: str):
        self.state_manager.purge(batch_uuid)

    def close(self):
        self.db.close()
