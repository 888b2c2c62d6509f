"""Process-wide serving counters."""
