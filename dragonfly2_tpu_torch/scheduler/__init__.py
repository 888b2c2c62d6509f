"""The scheduler: the in-process service, its resources and scheduling
core, the evaluators and their counters, and the replay plane (the
announce-stream recorder, the columnar store, the replay engine and its
benches)."""
