"""Build the hand-written CUDA kernels at first use and load them.

Each source under ``csrc/`` compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes), loaded with ``ctypes``. All sources build in
parallel, one ``nvcc`` process each. Libraries land in ``.build/`` next
to this file (listed in ``.gitignore``), named by a digest of the source,
the shared header and the flags, so an edited source never loads a stale
library; a finished library is renamed into place atomically, so
concurrent builds cannot load a half-written file.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from dragonfly2_tpu_torch.device import DeviceFault

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / ".build"
SOURCES = ("table_gather", "table_scatter_add", "graph_flash_attention",
           "flash_attention", "flash_attention_sm90")
# --split-compile=0: optimize a source's kernels in parallel on every core
# (flash_attention.cu holds 36 kernel instances).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise DeviceFault("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, dict]:
    """Compile every missing kernel library, all ``nvcc`` runs started
    together. Returns ``{source name: {"ptxas": report, "seconds": wall
    time of its nvcc}}`` for the sources built by this call (empty for
    ones already built). Raises with the compiler's output when any build
    fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = {name: _target(name) for name in SOURCES
                if not _target(name).exists()}
        if not todo:
            return {}
        nvcc = nvcc_path()
        procs, start = {}, time.perf_counter()
        for name, target in todo.items():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            log = target.with_suffix(f".{os.getpid()}.log")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            with open(log, "w") as fh:
                procs[name] = (subprocess.Popen(
                    cmd, stdout=fh, stderr=subprocess.STDOUT), tmp, target,
                    log)
        seconds = {}
        while len(seconds) < len(procs):
            for name, (proc, *_rest) in procs.items():
                if name not in seconds and proc.poll() is not None:
                    seconds[name] = time.perf_counter() - start
            time.sleep(0.05)
        reports, failures = {}, []
        for name, (proc, tmp, target, log) in procs.items():
            out = log.read_text()
            log.unlink()
            if proc.returncode != 0:
                failures.append(f"--- {name}.cu (exit {proc.returncode})\n{out}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, target)
            reports[name] = {"ptxas": out, "seconds": seconds[name]}
        if failures:
            raise DeviceFault("kernel build failed:\n" + "\n".join(failures))
        return reports


def open_library(path) -> ctypes.CDLL:
    """Load a built kernel library. Every library exports
    ``df2_error_string(int) -> const char*``."""
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as exc:
        raise DeviceFault(f"cannot load kernel library {path}: {exc}") from exc
    lib.df2_error_string.argtypes = [ctypes.c_int]
    lib.df2_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it if needed)."""
    if name not in SOURCES:
        raise KeyError(f"unknown kernel source {name!r}")
    build_all()
    return open_library(_target(name))


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point returned a nonzero ``cudaError_t``."""
    if rc != 0:
        msg = lib.df2_error_string(rc).decode(errors="replace")
        raise DeviceFault(f"{what}: CUDA error {rc} ({msg})")
