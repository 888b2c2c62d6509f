"""The federated bench's state-directory readers in the port
(``train/fedbench.py``'s ``best_recorded_federated_run`` and
``check_federated_regression``) against the JAX package's on the same
synthetic state directories."""

from __future__ import annotations

import json

import pytest

from dragonfly2_tpu.train import fedbench as jax_fedbench
from dragonfly2_tpu_torch.train import fedbench as port_fedbench


def run_record(*, verdict=True, skipped=False, kill=True, decisions=400,
               regret=0.01, poisoned=0.02):
    return {"verdict_pass": verdict, "skipped": skipped,
            "eval_decisions": decisions,
            "clean": {"federated_regret": regret},
            "poisoned": {"regret": poisoned},
            "kill": {"ran": kill}}


STATES = {
    "empty": {},
    "one": {"a": run_record()},
    "kill_beats_size": {"a": run_record(kill=False, decisions=900),
                        "b": run_record(kill=True, decisions=100)},
    "size_then_regret": {"a": run_record(decisions=400, regret=0.05),
                         "b": run_record(decisions=400, regret=0.01),
                         "c": run_record(decisions=300, regret=0.001)},
    "skips_and_failures": {"a": run_record(skipped=True),
                           "b": run_record(verdict=False),
                           "c": run_record(kill=False, regret=0.2)},
    "no_regret": {"a": run_record(regret=None),
                  "b": run_record(regret=0.3, decisions=10)},
    "unreadable": {"a": "not json", "b": run_record(decisions=50)},
}


def write_state(root, files: dict) -> str:
    root.mkdir(parents=True, exist_ok=True)
    for name, data in files.items():
        text = data if isinstance(data, str) else json.dumps(data)
        (root / f"federated_run_{name}.json").write_text(text)
    (root / "other_run_x.json").write_text(json.dumps(run_record()))
    return str(root)


@pytest.mark.parametrize("state", sorted(STATES))
def test_best_recorded_run_equals_jax(tmp_path, state):
    root = write_state(tmp_path / state, STATES[state])
    got = port_fedbench.best_recorded_federated_run(root)
    assert got == jax_fedbench.best_recorded_federated_run(root)
    assert (got is None) == (state in ("empty",))


@pytest.mark.parametrize("fresh", [
    {"verdict_pass": True, "clean": {"ok": True, "federated_regret": 0.01},
     "poisoned": {"ok": True, "screens_ok": True}},
    {"verdict_pass": False, "error": "RuntimeError: x",
     "clean": {"ok": False}, "poisoned": {}}])
def test_regression_check_equals_jax(tmp_path, monkeypatch, fresh):
    """The fresh run is the bench's (a card run in the port); both
    packages' checks read the same state directory around it."""
    root = write_state(tmp_path / "s", STATES["size_then_regret"])
    calls = {}

    def fake(pkg):
        def run(**kw):
            calls[pkg] = kw
            return fresh
        return run

    monkeypatch.setattr(port_fedbench, "run_federated_bench", fake("port"))
    monkeypatch.setattr(jax_fedbench, "run_federated_bench", fake("jax"))
    got = port_fedbench.check_federated_regression(root, device="cpu")
    assert got == jax_fedbench.check_federated_regression(root)
    assert calls["port"] == dict(calls["jax"], device="cpu")
    assert got["passed"] is fresh["verdict_pass"]
