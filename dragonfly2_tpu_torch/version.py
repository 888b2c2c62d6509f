"""Version information.

Reference counterpart: version/version.go (GitVersion = "v2.1.0"); we track
our own versioning scheme, starting at 0.1.0 for the round-1 vertical slice.
"""

__version__ = "0.1.0"

# Capability level of the reference implementation we are rebuilding.
REFERENCE_VERSION = "dragonfly2-v2.1.0"
