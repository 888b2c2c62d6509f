"""Embedded manager console (manager/manager.go:68-85 console dist).

The reference compiles a React app and embeds its dist in the Go binary;
here a dependency-free single page (``index.html``) ships inside the
package and is served at the manager root by the public REST surface.
"""

from __future__ import annotations

import os

_HTML_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "index.html")


def console_html() -> bytes:
    with open(_HTML_PATH, "rb") as f:
        return f.read()
