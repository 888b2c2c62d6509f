"""Scorers and the inference service."""
