"""Every module of the JAX package has its counterpart in the port: the
port does everything the JAX package does. The one exception is
``utils/compilecache.py`` (XLA's persistent compilation cache): the port
compiles no XLA, and ``ops/_build.py``'s digest-named build cache takes
its place."""

from __future__ import annotations

import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOSED = {"utils/compilecache.py"}


def _python_files(package: str) -> set:
    root = os.path.join(REPO, package)
    return {os.path.relpath(os.path.join(d, n), root)
            for d, _, names in os.walk(root) for n in names
            if n.endswith(".py")}


def test_every_jax_module_has_a_port_counterpart():
    missing = _python_files("dragonfly2_tpu") - _python_files(
        "dragonfly2_tpu_torch")
    assert missing == CLOSED


def test_the_closed_module_is_the_compile_cache_and_the_build_cache_exists():
    with open(os.path.join(REPO, "dragonfly2_tpu", "utils",
                           "compilecache.py")) as f:
        assert "compilation_cache" in f.read()
    with open(os.path.join(REPO, "dragonfly2_tpu_torch", "ops",
                           "_build.py")) as f:
        assert "digest" in f.read()
