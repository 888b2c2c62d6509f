"""Standard directory layout for services (pkg/dfpath/dfpath.go:240).

One place answering "where do data/cache/logs/plugins live" for every
service, honoring overrides the same way the reference's dfpath options
do. Defaults live under the workdir (container-friendly) instead of the
reference's /var/log + /usr/local hierarchy — overridable via
``DF2_HOME`` or explicit arguments.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _default_home() -> str:
    return os.environ.get("DF2_HOME", os.path.join(os.getcwd(), ".df2"))


@dataclass(frozen=True)
class DfPath:
    """Resolved layout for one service instance."""

    home: str = field(default_factory=_default_home)
    name: str = "df2"

    @property
    def data_dir(self) -> str:
        return os.path.join(self.home, self.name, "data")

    @property
    def cache_dir(self) -> str:
        return os.path.join(self.home, self.name, "cache")

    @property
    def log_dir(self) -> str:
        return os.path.join(self.home, self.name, "logs")

    @property
    def run_dir(self) -> str:
        return os.path.join(self.home, self.name, "run")

    @property
    def plugin_dir(self) -> str:
        return os.path.join(self.home, self.name, "plugins")

    def ensure(self) -> "DfPath":
        for d in (self.data_dir, self.cache_dir, self.log_dir,
                  self.run_dir, self.plugin_dir):
            os.makedirs(d, exist_ok=True)
        return self


def for_service(name: str, home: str = "") -> DfPath:
    return DfPath(home=home or _default_home(), name=name)
