"""Host type taxonomy.

Reference counterpart: pkg/types/types.go:80-140 (HostType). Seed peers come
in three strengths; ``NORMAL`` is an ordinary dfdaemon peer. The evaluator's
host-type score and the scheduling filters both branch on this.
"""

from __future__ import annotations

import enum


class HostType(enum.IntEnum):
    NORMAL = 0
    SUPER_SEED = 1
    STRONG_SEED = 2
    WEAK_SEED = 3

    @property
    def is_seed(self) -> bool:
        return self is not HostType.NORMAL

    @property
    def type_name(self) -> str:
        return _NAMES[self]

    @classmethod
    def from_name(cls, name: str) -> "HostType":
        try:
            return _BY_NAME[name.lower()]
        except KeyError:
            raise ValueError(f"unknown host type name {name!r}") from None


_NAMES = {
    HostType.NORMAL: "normal",
    HostType.SUPER_SEED: "super",
    HostType.STRONG_SEED: "strong",
    HostType.WEAK_SEED: "weak",
}
_BY_NAME = {v: k for k, v in _NAMES.items()}

# Separator for multi-element affinity strings (location), e.g.
# "country|province|city" — reference: pkg/types AffinitySeparator.
AFFINITY_SEPARATOR = "|"
