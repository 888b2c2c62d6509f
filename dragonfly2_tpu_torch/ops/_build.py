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
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / ".build"
SOURCES = ("table_gather", "table_scatter_add", "graph_flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every missing kernel library, all ``nvcc`` runs started
    together. Returns ``{source name: ptxas report}`` for the sources
    built by this call (empty for ones already built). Raises with the
    compiler's output when any build fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = {name: _target(name) for name in SOURCES
                if not _target(name).exists()}
        if not todo:
            return {}
        nvcc = nvcc_path()
        procs = {}
        for name, target in todo.items():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, target)
        reports, failures = {}, []
        for name, (proc, tmp, target) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"--- {name}.cu (exit {proc.returncode})\n{out}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, target)
            reports[name] = out
        if failures:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
        return reports


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it if needed).
    Every library exports ``df2_error_string(int) -> const char*``."""
    if name not in SOURCES:
        raise KeyError(f"unknown kernel source {name!r}")
    build_all()
    lib = ctypes.CDLL(str(_target(name)))
    lib.df2_error_string.argtypes = [ctypes.c_int]
    lib.df2_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point returned a nonzero ``cudaError_t``."""
    if rc != 0:
        msg = lib.df2_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
