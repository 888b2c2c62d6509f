"""Generic directed acyclic graph with cycle-safe edge insertion.

Reference counterpart: pkg/graph/dag/dag.go:50-300. Backs the per-task peer
tree: vertices are peers, an edge parent→child means the child downloads
pieces from the parent. ``can_add_edge`` is the scheduling filter's cycle
check (a peer must never become an ancestor of its own parent).
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Dict, Generic, Iterator, List, Set, TypeVar

T = TypeVar("T")


class VertexNotFoundError(KeyError):
    pass


class VertexExistsError(ValueError):
    pass


class CycleError(ValueError):
    pass


@dataclass
class Vertex(Generic[T]):
    id: str
    value: T
    parents: Set[str] = field(default_factory=set)
    children: Set[str] = field(default_factory=set)

    @property
    def in_degree(self) -> int:
        return len(self.parents)

    @property
    def out_degree(self) -> int:
        return len(self.children)


class DAG(Generic[T]):
    """Thread-safe DAG keyed by vertex id."""

    def __init__(self):
        self._vertices: Dict[str, Vertex[T]] = {}
        self._lock = threading.RLock()

    def __len__(self) -> int:
        return len(self._vertices)

    def __contains__(self, vertex_id: str) -> bool:
        return vertex_id in self._vertices

    def add_vertex(self, vertex_id: str, value: T) -> None:
        with self._lock:
            if vertex_id in self._vertices:
                raise VertexExistsError(vertex_id)
            self._vertices[vertex_id] = Vertex(vertex_id, value)

    def delete_vertex(self, vertex_id: str) -> None:
        with self._lock:
            v = self._vertices.pop(vertex_id, None)
            if v is None:
                return
            for p in v.parents:
                self._vertices[p].children.discard(vertex_id)
            for c in v.children:
                self._vertices[c].parents.discard(vertex_id)

    def vertex(self, vertex_id: str) -> Vertex[T]:
        try:
            return self._vertices[vertex_id]
        except KeyError:
            raise VertexNotFoundError(vertex_id) from None

    def values(self) -> Iterator[T]:
        return (v.value for v in list(self._vertices.values()))

    def _reachable(self, start: str, target: str) -> bool:
        """True if ``target`` is reachable from ``start`` along child edges."""
        stack = [start]
        seen = set()
        while stack:
            cur = stack.pop()
            if cur == target:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(self._vertices[cur].children)
        return False

    def can_add_edge(self, from_id: str, to_id: str) -> bool:
        """True when from→to would keep the graph acyclic (and both exist,
        and the edge isn't already present)."""
        with self._lock:
            if from_id == to_id:
                return False
            if from_id not in self._vertices or to_id not in self._vertices:
                return False
            if to_id in self._vertices[from_id].children:
                return False
            return not self._reachable(to_id, from_id)

    def add_edge(self, from_id: str, to_id: str) -> None:
        with self._lock:
            if not self.can_add_edge(from_id, to_id):
                raise CycleError(f"edge {from_id}→{to_id} rejected")
            self._vertices[from_id].children.add(to_id)
            self._vertices[to_id].parents.add(from_id)

    def delete_edge(self, from_id: str, to_id: str) -> None:
        with self._lock:
            if from_id in self._vertices:
                self._vertices[from_id].children.discard(to_id)
            if to_id in self._vertices:
                self._vertices[to_id].parents.discard(from_id)

    def delete_vertex_in_edges(self, vertex_id: str) -> None:
        """Disconnect the vertex from all its parents (reference:
        DeleteVertexInEdges — used when rescheduling a peer)."""
        with self._lock:
            v = self.vertex(vertex_id)
            for p in list(v.parents):
                self._vertices[p].children.discard(vertex_id)
            v.parents.clear()

    def delete_vertex_out_edges(self, vertex_id: str) -> None:
        with self._lock:
            v = self.vertex(vertex_id)
            for c in list(v.children):
                self._vertices[c].parents.discard(vertex_id)
            v.children.clear()

    def parents(self, vertex_id: str) -> List[T]:
        with self._lock:
            return [self._vertices[p].value for p in self.vertex(vertex_id).parents]

    def children(self, vertex_id: str) -> List[T]:
        with self._lock:
            return [self._vertices[c].value for c in self.vertex(vertex_id).children]

    def random_vertices(self, n: int, rng: random.Random | None = None) -> List[T]:
        """Up to n distinct random vertex values (reference:
        GetRandomVertices — the scheduling core's candidate pre-sample).

        ``random.sample`` instead of shuffle-then-slice: same uniform
        without-replacement draw with O(n) random-number work (the id
        materialization ``list(self._vertices)`` remains O(V) under the
        DAG lock — still a per-announce O(V) cost on large DAGs)."""
        with self._lock:
            ids = list(self._vertices)
            picked = (rng or random).sample(ids, min(n, len(ids)))
            return [self._vertices[i].value for i in picked]
