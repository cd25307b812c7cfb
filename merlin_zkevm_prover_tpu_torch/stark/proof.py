"""STARK proof containers (reference friProof.hpp analog) with JSON I/O."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass
class TreeOpening:
    """One Merkle query: the full leaf row plus the sibling digest path."""

    values: List[int]              # width felts
    siblings: List[List[int]]      # one 4-felt digest per level

    def to_json(self):
        return {"v": [str(x) for x in self.values],
                "mp": [[str(x) for x in s] for s in self.siblings]}

    @staticmethod
    def from_json(d):
        return TreeOpening([int(x) for x in d["v"]],
                           [[int(x) for x in s] for s in d["mp"]])


@dataclass
class StarkProof:
    name: str
    roots: List[List[int]]                    # 4 cm-tree roots (4 felts each)
    evals: List[List[int]]                    # size_eval x 3
    fri_roots: List[List[int]]                # per FRI step 1..last
    final_pol: List[List[int]]                # 2^lastBits x 3
    # queries[0][q] = dict tree_name -> TreeOpening (cm1..cm4, const)
    # queries[si][q] (si>=1) = TreeOpening into FRI tree si
    queries_step0: List[Dict[str, TreeOpening]] = field(default_factory=list)
    queries_fri: List[List[TreeOpening]] = field(default_factory=list)
    publics: List[int] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps({
            "name": self.name,
            "roots": [[str(x) for x in r] for r in self.roots],
            "evals": [[str(x) for x in e] for e in self.evals],
            "friRoots": [[str(x) for x in r] for r in self.fri_roots],
            "finalPol": [[str(x) for x in e] for e in self.final_pol],
            "queriesStep0": [
                {k: v.to_json() for k, v in q.items()} for q in self.queries_step0
            ],
            "queriesFri": [
                [o.to_json() for o in step] for step in self.queries_fri
            ],
            "publics": [str(x) for x in self.publics],
        })

    @staticmethod
    def from_json(s: str) -> "StarkProof":
        d = json.loads(s)
        return StarkProof(
            name=d["name"],
            roots=[[int(x) for x in r] for r in d["roots"]],
            evals=[[int(x) for x in e] for e in d["evals"]],
            fri_roots=[[int(x) for x in r] for r in d["friRoots"]],
            final_pol=[[int(x) for x in e] for e in d["finalPol"]],
            queries_step0=[
                {k: TreeOpening.from_json(v) for k, v in q.items()}
                for q in d["queriesStep0"]
            ],
            queries_fri=[
                [TreeOpening.from_json(o) for o in step] for step in d["queriesFri"]
            ],
            publics=[int(x) for x in d["publics"]],
        )
