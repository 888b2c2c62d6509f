"""The replay slice runs where the card machine has no JAX, gRPC,
pyarrow, pandas, psutil or prometheus_client: a fresh interpreter whose
import system refuses those packages (and ``dragonfly2_tpu``) drives the
whole slice on the CPU at test size — synthetic corpus, segment writer,
``open_dir``, ``check_corpus``, the sequential and vectorized ``ml`` and
``cost`` replays through the sidecar's artifact loaders,
``score_run_vectorized``, and the ``df2-replay`` tool; and the recording
half: the recorded A/B (``run_replay_ab``: swarm, recorder, rotating
dataset, training, the gate, rule vs ``ml`` vs ``cost``), the scheduler
ladder and the recorder-overhead guard at test size.

``tests/test_torch_isolation.py`` sees module-level imports only; a
function-level import of a refused package fails here.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFUSED = ("jax", "jaxlib", "flax", "optax", "orbax", "grpc", "pyarrow",
           "pandas", "psutil", "prometheus_client", "tensorstore",
           "dragonfly2_tpu")

_PRELUDE = r"""
import importlib.abc, json, os, sys, tempfile

REFUSED = set(json.loads(sys.argv[1]))
attempts = []


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            attempts.append(name)
            raise ModuleNotFoundError(f"{name} is refused here", name=name)
        return None


# torch's optimizers load torch._dynamo on first use, whose trace rules
# probe optional packages (pandas among them) with importlib's find_spec:
# on a machine without them the probe answers None, which a refusing
# finder cannot imitate. Load it first; the port's own imports follow.
import torch._dynamo  # noqa: E402,F401

sys.meta_path.insert(0, Refuse())
"""

_SCRIPT = _PRELUDE + r"""
import numpy as np
import torch

from dragonfly2_tpu_torch.cmd import replaytool
from dragonfly2_tpu_torch.inference.scorer import (
    LearnedCostEvaluator, MLEvaluator)
from dragonfly2_tpu_torch.inference.sidecar import (
    _cost_scorer_from_artifact, _scorer_from_artifact)
from dragonfly2_tpu_torch.models.mlp import MLPBandwidthPredictor, Normalizer
from dragonfly2_tpu_torch.scheduler import replay, replaystore
from dragonfly2_tpu_torch.scheduler.replaybench import (
    run_replay_throughput_ladder, synth_replay_corpus)
from dragonfly2_tpu_torch.train.checkpoint import (
    ModelMetadata, flax_from_mlp_state_dict, mlp_tree, write_artifact)
from dragonfly2_tpu_torch.train.cost_trainer import cost_examples_from_corpus

out = {}
tmp = tempfile.mkdtemp(prefix="df2-cardless-")
cc = synth_replay_corpus(600, seed=5)
events = cc.to_events()
writer = replaystore.ReplayStoreWriter(os.path.join(tmp, "store"),
                                       segment_decisions=200)
for start in range(0, len(events), 200):
    writer.append_batch(events[start:start + 200])
writer.close()
segments = writer.segments()
opened = replaystore.open_dir(os.path.join(tmp, "store"))
out["segments"] = len(segments)
out["checks_ok"] = all(replaystore.check_corpus(p)["ok"] for p in segments)
out["columns_equal"] = all(
    np.array_equal(opened.columns()[k], cc.columns()[k])
    for k in replaystore.ALL_COLUMNS)
X, y = cost_examples_from_corpus(opened)
out["cost_examples"] = len(X)

model = MLPBandwidthPredictor(hidden=(16, 8), dtype=torch.float32,
                              generator=torch.Generator().manual_seed(0))
norm = Normalizer.fit(X)
artifacts = {}
for kind in ("mlp", "cost"):
    target = Normalizer(np.array([0.05], np.float32),
                        np.array([0.3], np.float32))
    artifacts[kind] = write_artifact(
        mlp_tree(flax_from_mlp_state_dict(model.state_dict()), norm, target),
        ModelMetadata(model_id=f"cardless-{kind}", model_type=kind,
                      config={"hidden": [16, 8]}))
evaluators = {
    "rule": lambda: None,
    "ml": lambda: MLEvaluator(_scorer_from_artifact(artifacts["mlp"],
                                                    device="cpu")),
    "cost": lambda: LearnedCostEvaluator(_cost_scorer_from_artifact(
        artifacts["cost"], version="v1", device="cpu")),
}
rule_digest = None
for name, make in evaluators.items():
    from dragonfly2_tpu_torch.scheduler.evaluator import BaseEvaluator

    seq_ev, vec_ev = make() or BaseEvaluator(), make()
    seq = replay.replay_decisions(opened.slice(0, 300).decisions(), seq_ev)
    part = replay.replay_decisions_vectorized(opened.slice(0, 300), vec_ev)
    whole = replay.replay_decisions_vectorized(opened, vec_ev, shards=2)
    scored = replay.score_run_vectorized(
        opened, whole, bad_node_verdicts=replay.rule_bad_node_verdicts(opened))
    out[name] = {"seq_equals_vec": seq.digest == part.digest,
                 "decisions": scored["decisions"],
                 "regret_scored": scored["regret_scored"]}
    if name == "rule":
        rule_digest = whole.digest
    else:
        out[name]["differs_from_rule"] = whole.digest != rule_digest

ladder = run_replay_throughput_ladder(rungs=(200,), bound=0.0)
out["ladder_digests_equal"] = ladder["rungs"][0]["digests_equal"]
csv_dir = os.path.join(tmp, "csv")
os.makedirs(csv_dir)
from dragonfly2_tpu_torch.schema import ReplayDecision
from dragonfly2_tpu_torch.schema.io import CsvRecordWriter

with CsvRecordWriter(ReplayDecision, os.path.join(csv_dir, "replay.csv")) as w:
    for e in events[:50]:
        w.write(e)
packed = os.path.join(tmp, "packed.npc")
out["tool"] = [
    replaytool.main(["pack", csv_dir, "-o", packed]),
    replaytool.main(["check", packed] + segments),
    replaytool.main(["stat", packed, "--json"]),
]
out["attempts"] = attempts
print(json.dumps(out))
"""


_RECORDING = _PRELUDE + r"""
import torch

torch.set_num_threads(1)
from dragonfly2_tpu_torch.scheduler.loadbench import (
    run_recorder_overhead_guard, run_swarm_ladder)
from dragonfly2_tpu_torch.scheduler.replaybench import run_replay_ab

ab = run_replay_ab(record_peers=150, workers=2, overhead_guard=False,
                   device="cpu")
ladder = run_swarm_ladder((20, 60), workers=2)
guard = run_recorder_overhead_guard(n_peers=40, reps=1, retry_reps=0)
print(json.dumps({
    "error": ab.get("error"), "record": ab.get("record"),
    "gates": {n: g["state"] for n, g in (ab.get("gate") or {}).items()},
    "evaluators": sorted((ab.get("ab") or {}).get("evaluators") or {}),
    "deterministic": (ab.get("ab") or {}).get("deterministic"),
    "rungs": sorted(ladder["ladder"]),
    "ladder_errors": [r["errors"] for r in ladder["ladder"].values()],
    "guard_keys": sorted(guard), "attempts": attempts}))
"""


def run_refusing(script: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", script, json.dumps(REFUSED)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_replay_slice_runs_without_the_missing_packages():
    out = run_refusing(_SCRIPT)
    assert out["segments"] == 3
    assert out["checks_ok"] and out["columns_equal"]
    assert out["cost_examples"] > 1000
    for name in ("rule", "ml", "cost"):
        assert out[name]["seq_equals_vec"], name
        assert out[name]["decisions"] == 600, name
        assert out[name]["regret_scored"] > 100, name
    assert out["ml"]["differs_from_rule"] and out["cost"]["differs_from_rule"]
    assert out["ladder_digests_equal"] is True
    assert out["tool"] == [0, 0, 0]
    assert out["attempts"] == []


def test_recording_half_runs_without_the_missing_packages():
    out = run_refusing(_RECORDING)
    assert out["error"] is None
    assert out["record"]["corpus_decisions"] == 150
    assert out["record"]["errors"] == []
    # A gate's verdict on a 150-peer corpus may go either way (the MLP's
    # rank-correlation floor); what matters here is that it was reached.
    assert set(out["gates"]) == {"cost", "mlp"}
    assert set(out["gates"].values()) <= {"active", "quarantined"}
    names = {"cost": "cost", "mlp": "ml"}
    assert out["evaluators"] == sorted(
        ["rule"] + [names[n] for n, state in out["gates"].items()
                    if state == "active"])
    assert out["deterministic"] is True
    assert out["rungs"] == ["20", "60"]
    assert out["ladder_errors"] == [[], []]
    assert {"p99_ratio", "bound", "within_bound"} <= set(out["guard_keys"])
    assert out["attempts"] == []
