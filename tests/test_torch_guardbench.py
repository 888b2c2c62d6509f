"""The poisoned-model rung (``inference/guardbench``) against the JAX
package's, on the CPU.

- the rule-distilled MLP: JAX's trained params, served by the port,
  score the gate's synthetic traces as JAX's sidecar does (both in
  bf16); the port's own distillation clears the gate's 0.5 rank floor
  as JAX's does;
- artifacts: good, NaN- and zero-poisoned, each package's
  ``write_model_artifact`` through its own ``ManagerService`` gate,
  give the same verdicts;
- the whole rung on the CPU: verdict true, the JAX report's keys;
- without a card, the rung raises ``DeviceFault`` instead of falling
  back to the CPU.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

from dragonfly2_tpu import manager as jax_manager
from dragonfly2_tpu.inference import guardbench as jax_guardbench
from dragonfly2_tpu.inference import sidecar as jax_sidecar
from dragonfly2_tpu.manager import service as jax_service
from dragonfly2_tpu.manager import validation as jax_validation
from dragonfly2_tpu.utils.servingstats import ServingStats as JaxStats
from dragonfly2_tpu_torch import manager as port_manager
from dragonfly2_tpu_torch.device import DeviceFault
from dragonfly2_tpu_torch.inference import guardbench as port_guardbench
from dragonfly2_tpu_torch.inference import sidecar as port_sidecar
from dragonfly2_tpu_torch.manager import database as port_database
from dragonfly2_tpu_torch.manager import service as port_service
from dragonfly2_tpu_torch.manager import validation as port_validation
from dragonfly2_tpu_torch.utils.servingstats import ServingStats

# Both packages serve the MLP in bf16 on the same params
# (tests/test_torch_lifecycle.py's tolerance).
BF16_TOL = 6e-2
GATE_FLOOR = 0.5  # the rung's ValidationConfig(min_rank_correlation=...)


@pytest.fixture(scope="module")
def jax_distilled():
    return jax_guardbench.train_rule_distilled_mlp(seed=0)


def _numpy_result(result):
    """JAX's training result with numpy leaves: what the port's
    ``write_model_artifact`` reads (params, normalizers, mae)."""
    params = {"params": {k: {n: np.asarray(v) for n, v in layer.items()}
                         for k, layer in result.params["params"].items()}}
    return types.SimpleNamespace(params=params, normalizer=result.normalizer,
                                 target_norm=result.target_norm,
                                 mae=float(result.mae))


def _traces():
    return port_validation.synthetic_traces(seed=0, batches=8, rows=12)


def test_distilled_params_score_as_jax(jax_distilled, tmp_path):
    jax_dir = jax_guardbench.write_model_artifact(
        str(tmp_path / "jax"), jax_distilled, "good")
    port_dir = port_guardbench.write_model_artifact(
        str(tmp_path / "port"), _numpy_result(jax_distilled), "good")
    jax_scorer = jax_sidecar._scorer_from_artifact(
        jax_service._tar_directory(jax_dir))
    port_scorer = port_sidecar._scorer_from_artifact(
        port_service._tar_directory(port_dir), device="cpu")
    for batch in _traces():
        want = np.asarray(jax_scorer.score(batch), np.float32)
        got = np.asarray(port_scorer.score(batch), np.float32)
        assert got.shape == want.shape == (12,)
        np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=0)


def test_port_distillation_clears_the_gate_as_jax(jax_distilled, tmp_path):
    port_result = port_guardbench.train_rule_distilled_mlp(seed=0,
                                                           device="cpu")
    jax_report = jax_validation.validate_artifact(
        "mlp", jax_service._tar_directory(jax_guardbench.write_model_artifact(
            str(tmp_path / "jax"), jax_distilled, "good")), None,
        jax_validation.ValidationConfig(min_rank_correlation=GATE_FLOOR))
    port_report = port_validation.validate_artifact(
        "mlp", port_service._tar_directory(
            port_guardbench.write_model_artifact(
                str(tmp_path / "port"), port_result, "good")), None,
        port_validation.ValidationConfig(min_rank_correlation=GATE_FLOOR),
        device="cpu")
    assert jax_report.passed and port_report.passed, (
        jax_report.to_dict(), port_report.to_dict())
    assert port_report.rank_correlation >= GATE_FLOOR
    assert jax_report.rank_correlation >= GATE_FLOOR
    assert np.isfinite(port_result.mae)


@pytest.mark.parametrize("poison", [None, "nan", "zero"])
def test_artifact_gate_verdicts_match_jax(jax_distilled, tmp_path, poison):
    verdicts = {}
    for name, guard, managers, validation, stats, kw, result in (
            ("jax", jax_guardbench, jax_manager, jax_validation, JaxStats,
             {}, jax_distilled),
            ("port", port_guardbench, port_manager, port_validation,
             ServingStats, {"device": "cpu"},
             _numpy_result(jax_distilled))):
        manager = managers.ManagerService(
            managers.Database(),
            managers.FilesystemObjectStore(str(tmp_path / name / "objects")),
            validation=validation.ValidationConfig(
                min_rank_correlation=GATE_FLOOR),
            serving_stats=stats(), **kw)
        path = guard.write_model_artifact(str(tmp_path / name), result,
                                          str(poison), poison=poison)
        row = manager.create_model("df2-mlp-guard", "mlp", "h", "127.0.0.1",
                                   "mlguard", {}, path,
                                   scheduler_id=guard.SCHEDULER_ID)
        report = (row.evaluation or {}).get("validation", {})
        verdicts[name] = (row.state, report.get("passed"),
                          report.get("trace_source"), report.get("reasons"))
    assert verdicts["port"] == verdicts["jax"]
    assert verdicts["port"][0] == (port_database.STATE_ACTIVE
                                   if poison is None
                                   else port_database.STATE_QUARANTINED)


def _jax_report_keys(monkeypatch) -> dict:
    """The keys of JAX's report, which are all there from the start: its
    rung cut short before the model trains."""
    def stop(*args, **kwargs):
        raise RuntimeError("cut short")

    monkeypatch.setattr(jax_guardbench, "train_rule_distilled_mlp", stop)
    report = jax_guardbench.run_mlguard_rung(seed=0)
    assert report["error"] == "RuntimeError: cut short"
    return report


def test_whole_rung_passes_on_the_cpu(monkeypatch):
    report = port_guardbench.run_mlguard_rung(seed=0, device="cpu")
    assert report["error"] is None, report["error"]
    assert report["verdict_pass"], json.dumps(report, default=str)
    assert report["reload_interval_s"] == 2.0
    assert report["gate"]["trace_source"] == "recorded"

    want = _jax_report_keys(monkeypatch)
    assert set(report) == set(want)
    for part in ("gate", "shadow_phase", "guard_phase"):
        assert set(report[part]) == set(want[part]), part
    assert set(report["counters"]) == {"scored", "fallbacks"} | set(
        JaxStats().snapshot())
    assert set(report["registry"]) == {
        "good_version", "gate_poison_version", "shadow_poison_version",
        "live_poison_version", "states"}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_rung_without_a_card_raises_device_fault():
    with pytest.raises(DeviceFault):
        port_guardbench.run_mlguard_rung(seed=0)


def test_best_recorded_run_matches_jax(tmp_path):
    runs = [
        {"verdict_pass": True, "guard_phase": {"rollback_s": 2.4}, "n": 0},
        {"verdict_pass": True, "guard_phase": {"rollback_s": 1.9}, "n": 1},
        {"verdict_pass": False, "guard_phase": {"rollback_s": 0.5}, "n": 2},
        {"skipped": True, "verdict_pass": True,
         "guard_phase": {"rollback_s": 0.1}, "n": 3},
        {"verdict_pass": True, "guard_phase": {"rollback_s": None}, "n": 4},
    ]
    for i, run in enumerate(runs):
        (tmp_path / f"mlguard_run_{i}.json").write_text(json.dumps(run))
    (tmp_path / "mlguard_run_bad.json").write_text("{not json")
    got = port_guardbench.best_recorded_mlguard(str(tmp_path))
    assert got == jax_guardbench.best_recorded_mlguard(str(tmp_path))
    assert got["n"] == 1
    assert port_guardbench.best_recorded_mlguard(str(tmp_path / "none")) \
        is None


def _keys(node):
    if isinstance(node, dict):
        return {k: _keys(v) for k, v in node.items()}
    return None


@pytest.mark.slow
@pytest.mark.mlguard
def test_rung_side_by_side_with_jax():
    jax_report = jax_guardbench.run_mlguard_rung(seed=0)
    port_report = port_guardbench.run_mlguard_rung(seed=0, device="cpu")
    assert jax_report["verdict_pass"] and port_report["verdict_pass"]
    for report in (jax_report, port_report):
        # Versions are random ids: compare the registry by its states.
        report["registry"]["states"] = sorted(
            report["registry"]["states"].values())
    assert _keys(port_report) == _keys(jax_report)
    assert port_report["registry"]["states"] == \
        jax_report["registry"]["states"]
    assert port_report["gate"] == jax_report["gate"]
