"""Checkpoint artifacts (training itself is not ported yet)."""
