"""ctypes loader for the native piece data plane (``pieceio.cpp``).

Reference counterpart: the reference daemon's data plane is compiled
native code end to end (Go). Here the control plane stays Python and the
two per-piece hot loops are C++, built on demand with ``g++`` and loaded
via ctypes — no pybind11, no build step at install time, and a clean
pure-Python fallback when the toolchain or the platform is missing
(callers check :func:`available` and keep their original code path).

The compiled object is cached under the dfpath cache directory keyed by
the source hash, so one process pays the ~1 s compile once per source
version and every later import is a dlopen. ``DF2_DISABLE_NATIVE=1``
forces the fallback (used by tests to pin down both paths).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

logger = logging.getLogger(__name__)

_SOURCE = os.path.join(os.path.dirname(__file__), "pieceio.cpp")
ABI_VERSION = 2
ERR_MALFORMED = -1000000

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _so_path(tag: str) -> str:
    """Compiled-object location. Prefer alongside the source (stable
    across processes regardless of cwd — dfpath's default home is
    cwd-relative, which would make every daemon/test with a fresh cwd
    pay the g++ run again); fall back to the dfpath cache when the
    package directory is read-only (installed site-packages)."""
    pkg_dir = os.path.dirname(__file__)
    name = f"df2native-{tag}.so"
    if os.access(pkg_dir, os.W_OK):
        return os.path.join(pkg_dir, name)
    from dragonfly2_tpu_torch.utils.dfpath import for_service

    return os.path.join(for_service("native").ensure().cache_dir, name)


def _build_and_load() -> Optional[ctypes.CDLL]:
    if os.environ.get("DF2_DISABLE_NATIVE") == "1":
        logger.info("native data plane disabled via DF2_DISABLE_NATIVE")
        return None
    try:
        with open(_SOURCE, "rb") as f:
            src = f.read()
    except OSError as exc:
        logger.warning("native source missing: %s", exc)
        return None
    tag = hashlib.sha256(src).hexdigest()[:16]
    so_path = _so_path(tag)
    if not os.path.exists(so_path):
        tmp = f"{so_path}.tmp.{os.getpid()}"
        cmd = ["g++", "-O3", "-Wall", "-shared", "-fPIC", "-o", tmp, _SOURCE]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=120)
        except (OSError, subprocess.TimeoutExpired) as exc:
            logger.warning("native build failed to run (%s); "
                           "using pure-Python data plane", exc)
            return None
        if proc.returncode != 0:
            logger.warning("native build failed:\n%s\n"
                           "using pure-Python data plane", proc.stderr)
            return None
        os.replace(tmp, so_path)  # atomic vs concurrent builders
    try:
        lib = ctypes.CDLL(so_path)
    except OSError as exc:
        logger.warning("native load failed: %s", exc)
        return None

    lib.df2_native_abi_version.restype = ctypes.c_int32
    if lib.df2_native_abi_version() != ABI_VERSION:
        logger.warning("native ABI mismatch; using pure-Python data plane")
        return None
    lib.df2_send_file_range.restype = ctypes.c_int64
    lib.df2_send_file_range.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64]
    lib.df2_http_fetch_to_file.restype = ctypes.c_int64
    lib.df2_http_fetch_to_file.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.df2_md5_file_range.restype = ctypes.c_int64
    lib.df2_md5_file_range.argtypes = [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p]
    lib.df2_md5_ctx_size.restype = ctypes.c_int64
    lib.df2_md5_ctx_size.argtypes = []
    lib.df2_md5_ctx_init.restype = None
    lib.df2_md5_ctx_init.argtypes = [ctypes.c_void_p]
    lib.df2_md5_ctx_update.restype = None
    lib.df2_md5_ctx_update.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.df2_md5_ctx_hex.restype = None
    lib.df2_md5_ctx_hex.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.df2_splice_recv_to_file.restype = ctypes.c_int64
    lib.df2_splice_recv_to_file.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None:
        return _lib
    with _lock:
        if not _tried:
            _tried = True
            _lib = _build_and_load()
    return _lib


def available() -> bool:
    """True when the compiled data plane is loadable on this host."""
    return _get() is not None


def reset_for_tests() -> None:
    """Forget the cached handle so tests can flip DF2_DISABLE_NATIVE."""
    global _lib, _tried
    with _lock:
        _lib = None
        _tried = False


class NativeIOError(OSError):
    pass


def send_file_range(out_fd: int, in_fd: int, offset: int, count: int) -> int:
    """Serve file bytes to a socket (sendfile fast path). Returns bytes
    sent; raises :class:`NativeIOError` on IO failure."""
    lib = _get()
    assert lib is not None, "call available() first"
    n = lib.df2_send_file_range(out_fd, in_fd, offset, count)
    if n < 0:
        raise NativeIOError(-n, os.strerror(int(-n)))
    return int(n)


@dataclass(frozen=True)
class FetchResult:
    body_len: int
    status: int
    keep_alive: bool
    md5_hex: str  # empty when the body was drained instead of stored


def http_fetch_to_file(sock_fd: int, request: bytes, file_fd: int,
                       file_offset: int, expected_len: int) -> FetchResult:
    """One request/response over a connected socket with the body
    streamed to ``file_fd`` (recv → pwrite → MD5, all in C). Only a 2xx
    body of exactly ``expected_len`` bytes touches the file; anything
    else is drained (``md5_hex`` stays empty). Raises
    :class:`NativeIOError` on socket/file errors and ``ValueError`` on
    an unparseable response (caller drops the connection)."""
    lib = _get()
    assert lib is not None, "call available() first"
    md5_out = ctypes.create_string_buffer(33)
    status = ctypes.c_int32(0)
    keep = ctypes.c_int32(0)
    n = lib.df2_http_fetch_to_file(
        sock_fd, request, len(request), file_fd, file_offset, expected_len,
        md5_out, ctypes.byref(status), ctypes.byref(keep))
    if n == ERR_MALFORMED:
        raise ValueError("malformed HTTP response")
    if n < 0:
        raise NativeIOError(-n, os.strerror(int(-n)))
    return FetchResult(body_len=int(n), status=int(status.value),
                       keep_alive=bool(keep.value),
                       md5_hex=md5_out.value.decode())


def md5_file_range(fd: int, offset: int, count: int) -> Tuple[int, str]:
    """(bytes_digested, md5_hex) for a stored span."""
    lib = _get()
    assert lib is not None, "call available() first"
    out = ctypes.create_string_buffer(33)
    n = lib.df2_md5_file_range(fd, offset, count, out)
    if n < 0:
        raise NativeIOError(-n, os.strerror(int(-n)))
    return int(n), out.value.decode()


class Md5:
    """Resumable native MD5 with the hashlib surface the download ops
    use (``update`` / ``hexdigest``). The context lives in a ctypes
    buffer so :func:`splice_recv_to_file` can hand its address to C and
    accumulate spliced bytes into the SAME digest stream as Python-fed
    header-surplus bytes — one digest per piece, regardless of which
    side of the ctypes boundary each burst landed on."""

    __slots__ = ("_buf",)

    def __init__(self) -> None:
        lib = _get()
        assert lib is not None, "call available() first"
        self._buf = ctypes.create_string_buffer(int(lib.df2_md5_ctx_size()))
        lib.df2_md5_ctx_init(ctypes.addressof(self._buf))

    @property
    def ctx_addr(self) -> int:
        return ctypes.addressof(self._buf)

    def update(self, data) -> None:
        if data:
            b = data if isinstance(data, bytes) else bytes(data)
            _get().df2_md5_ctx_update(ctypes.addressof(self._buf), b, len(b))

    def hexdigest(self) -> str:
        out = ctypes.create_string_buffer(33)
        _get().df2_md5_ctx_hex(ctypes.addressof(self._buf), out)
        return out.value.decode()


@dataclass(frozen=True)
class SpliceResult:
    nbytes: int
    eof: bool
    zero_copy: bool  # True when the bytes moved via splice(2), no copy


def splice_recv_to_file(sock_fd: int, file_fd: int, offset: int, want: int,
                        md5: Optional[Md5] = None,
                        pipe: Tuple[int, int] = (-1, -1)) -> SpliceResult:
    """Land up to ``want`` socket bytes at ``offset`` of ``file_fd`` with
    PARTIAL progress on EAGAIN — the download-side mirror of
    :func:`send_file_range`. With ``md5=None`` and a scratch ``pipe``
    the bytes move zero-copy via splice(2); otherwise (inline digest
    wanted, or no pipe) a recv→pwrite→MD5 loop runs entirely in C.
    Raises :class:`NativeIOError` on IO failure."""
    lib = _get()
    assert lib is not None, "call available() first"
    eof = ctypes.c_int32(0)
    mode = ctypes.c_int32(0)
    n = lib.df2_splice_recv_to_file(
        sock_fd, file_fd, offset, want,
        None if md5 is None else md5.ctx_addr, pipe[0], pipe[1],
        ctypes.byref(eof), ctypes.byref(mode))
    if n < 0:
        raise NativeIOError(-n, os.strerror(int(-n)))
    return SpliceResult(nbytes=int(n), eof=bool(eof.value),
                        zero_copy=(mode.value == 1))
