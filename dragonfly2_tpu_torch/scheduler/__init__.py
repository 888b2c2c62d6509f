"""Scheduler-side pieces the learned evaluators need: the evaluators,
their counters, and the replay plane's row helpers."""
