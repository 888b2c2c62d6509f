"""RPC status codes, the wire's error and the in-process call context.

A service method's ``context`` needs ``abort(code, details)`` taking a
:class:`StatusCode` and raising, as gRPC's does: :class:`CallContext` is
the in-process one, and raises :class:`RpcAbort`; the wire's server
context (``rpc/service.py``) raises the same. A call made over the wire
(``rpc/client.py``) that ends with a status other than OK raises
:class:`RpcError`, whose ``code()`` and ``details()`` are grpc's
``RpcError`` methods, so callers port line for line.
"""

from __future__ import annotations

import enum


class StatusCode(enum.Enum):
    """RPC status codes, named and numbered as gRPC's."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class RpcAbort(Exception):
    """Raised by :meth:`CallContext.abort` (and the wire server's
    ``abort``): ends the call with ``code`` and ``details``."""

    def __init__(self, code: StatusCode, details: str):
        super().__init__(f"{code.name}: {details}")
        self.code = code
        self.details = details


class RpcError(Exception):
    """A call over the wire that ended with a status other than OK."""

    def __init__(self, code: StatusCode, details: str = ""):
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


class CallContext:
    """In-process call context: ``abort`` raises :class:`RpcAbort`."""

    def abort(self, code: StatusCode, details: str):
        raise RpcAbort(code, details)
