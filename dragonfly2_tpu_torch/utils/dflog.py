"""Rotated per-concern file logging.

Reference counterpart: internal/dflog (logger.go:367, logcore.go) — zap
loggers split by concern (core, grpc, gc, storage, ...) each writing a
size-rotated file under the service's log directory, with an optional
console mirror. Here the same layout rides stdlib logging +
RotatingFileHandler; ``init_file_logging`` maps logger-name prefixes onto
per-concern files so a service gets core.log / grpc.log / gc.log /
storage.log exactly like the reference's dfpath layout.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Dict, Optional

DEFAULT_MAX_BYTES = 100 * 1024 * 1024  # lumberjack defaults in logcore.go
DEFAULT_BACKUPS = 3

# Logger-name prefix → concern file. First match wins; everything else
# lands in core.log.
CONCERNS = {
    "dragonfly2_tpu_torch.rpc": "grpc",
    "dragonfly2_tpu_torch.utils.gc": "gc",
    "dragonfly2_tpu_torch.client.storage": "storage",
    "dragonfly2_tpu_torch.scheduler.storage": "storage",
}

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


class _ConcernFilter(logging.Filter):
    def __init__(self, prefixes, invert: bool = False):
        super().__init__()
        self.prefixes = tuple(prefixes)
        self.invert = invert

    def filter(self, record: logging.LogRecord) -> bool:
        matched = record.name.startswith(self.prefixes)
        return not matched if self.invert else matched


def init_file_logging(
    log_dir: str,
    *,
    level: int = logging.INFO,
    console: bool = True,
    max_bytes: int = DEFAULT_MAX_BYTES,
    backup_count: int = DEFAULT_BACKUPS,
    concerns: Optional[Dict[str, str]] = None,
) -> Dict[str, str]:
    """Install rotated per-concern handlers on the root logger.

    Returns {concern: file_path}. Idempotent per (log_dir): existing
    handlers pointing into ``log_dir`` are replaced, not duplicated.
    """
    concerns = dict(CONCERNS if concerns is None else concerns)
    os.makedirs(log_dir, exist_ok=True)
    root = logging.getLogger()
    root.setLevel(level)
    # Drop any previous handlers writing into this directory.
    for handler in list(root.handlers):
        base = getattr(handler, "baseFilename", "")
        if base and os.path.dirname(base) == os.path.abspath(log_dir):
            root.removeHandler(handler)
            handler.close()

    files: Dict[str, str] = {}
    by_file: Dict[str, list] = {}
    for prefix, concern in concerns.items():
        by_file.setdefault(concern, []).append(prefix)
    fmt = logging.Formatter(_FORMAT)
    all_prefixes = []
    for concern, prefixes in by_file.items():
        path = os.path.join(log_dir, f"{concern}.log")
        handler = logging.handlers.RotatingFileHandler(
            path, maxBytes=max_bytes, backupCount=backup_count)
        handler.setFormatter(fmt)
        handler.addFilter(_ConcernFilter(prefixes))
        root.addHandler(handler)
        files[concern] = path
        all_prefixes.extend(prefixes)
    core_path = os.path.join(log_dir, "core.log")
    core = logging.handlers.RotatingFileHandler(
        core_path, maxBytes=max_bytes, backupCount=backup_count)
    core.setFormatter(fmt)
    core.addFilter(_ConcernFilter(all_prefixes, invert=True))
    root.addHandler(core)
    files["core"] = core_path
    if console and not any(
        isinstance(h, logging.StreamHandler)
        and not isinstance(h, logging.FileHandler)
        for h in root.handlers
    ):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        root.addHandler(sh)
    return files
