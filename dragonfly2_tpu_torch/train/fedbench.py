"""Byzantine-robust federated rounds, proven — port of
``dragonfly2_tpu/train/fedbench.py``.

Three rungs over heterogeneous profiled-cost cluster corpora (each
cluster's candidates live in a distinct band of the cost-driving
features, so a solo model extrapolates poorly off its own band while
the federated aggregate has seen them all):

1. **Clean** — a :class:`~dragonfly2_tpu_torch.trainer.federation.
   FederationCoordinator` run commits screened rounds, the aggregate
   registers under ``GLOBAL_SCHEDULER_ID`` through the registry's
   validation gate, and the replay A/B scores it against every
   single-cluster solo model and the rule baseline: the federated
   model's realized-cost regret must not exceed the BEST solo's by more
   than ``FED_UPLIFT_BOUND``.
2. **Poisoned** — the same honest fleet plus a label-flipped corpus
   (lying cluster) and a NaN-params endpoint (dying trainer's poisoned
   update). Both must be screened every round (``nonfinite`` /
   ``holdout_regression`` reasons in lineage), the persistent liar must
   escalate to registry quarantine, and the poisoned-fleet global must
   hold replay regret within ``POISON_REGRET_FACTOR`` × the clean run.
3. **Coordinator kill** — a subprocess coordinator (``train/fedproc.py``)
   is SIGKILLed mid-round after at least two updates hit the durable
   journal; its restart must resume the SAME round from the journal,
   retrain NONE of the journaled clusters (proven by the per-fit counter
   file), and commit with quorum.

The state-directory readers of the JAX module (the best recorded run and
the regression check) wait for the port's benchmark.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from dragonfly2_tpu_torch.device import default_device
from dragonfly2_tpu_torch.scheduler.replaystore import (
    ColumnarCorpus,
    bucket_candidates,
)
from dragonfly2_tpu_torch.train.checkpoint import (
    ModelMetadata,
    mlp_tree,
    save_model,
)
from dragonfly2_tpu_torch.train.federated import (
    GLOBAL_SCHEDULER_ID,
    FederatedConfig,
    cluster_datasets_from_corpora,
)
from dragonfly2_tpu_torch.parallel.mesh import LOCAL
from dragonfly2_tpu_torch.train.mlp_trainer import MLPTrainConfig, train_mlp

#: The checkout root: ``run_federated_kill``'s child runs from it, so
#: ``python -m dragonfly2_tpu_torch...`` finds the package.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: The federated model's replay regret may exceed the best solo model's
#: by at most this factor (plus the absolute slack) — at 1.0 federation
#: must match-or-beat its best member on the mixed eval corpus.
FED_UPLIFT_BOUND = 1.0

#: Poisoned-fleet global regret bound relative to the clean run
#: (the screens keep the damage within 1.2x).
POISON_REGRET_FACTOR = 1.2

#: Micro-regret corpora must not fail on noise (replaybench discipline).
ABS_SLACK_S = 0.002

MIN_EVAL_DECISIONS = 120

#: Feature bands per cluster: (upload_failed, free_upload_count,
#: concurrent_upload_limit) ranges. The true cost is nonlinear across
#: the bands (quadratic load term + multiplicative interactions), so a
#: model trained inside one band mis-ranks candidates from the others.
CLUSTER_BANDS = (
    {"fail": (0, 8), "free": (0, 35), "limit": (200, 300)},
    {"fail": (8, 22), "free": (30, 65), "limit": (120, 220)},
    {"fail": (22, 45), "free": (60, 100), "limit": (50, 140)},
)


def true_piece_cost(feats: np.ndarray) -> np.ndarray:
    """Deterministic ground-truth piece cost (seconds) from the canonical
    11-dim feature rows — the learnable signal every rung shares."""
    fail = feats[..., 4]
    upload = feats[..., 3]
    free = feats[..., 5]
    limit = np.maximum(feats[..., 6], 1.0)
    ready = feats[..., 8]
    idc = feats[..., 9]
    loc = feats[..., 10]
    fail_frac = fail / (upload + fail + 1.0)
    # free_upload_count is SPARE capacity (scoring.rule_scores rewards
    # free/limit): a parent with no free slots is the busy one.
    busy = 1.0 - np.clip(free / limit, 0.0, 1.0)
    return (0.05
            * (1.0 + 4.0 * fail_frac)
            * (1.0 + 1.5 * busy * busy)
            * (1.0 - 0.35 * idc)
            * (1.0 - 0.05 * loc)
            * (1.0 - 0.30 * ready))


def synth_federated_corpus(n_decisions: int, *, seed: int = 0,
                           band: Optional[int] = None):
    """Deterministic synthetic corpus whose realized costs FOLLOW the
    features (``true_piece_cost`` + 5% seeded noise) — learnable,
    which the uplift rung needs. The same seed gives the JAX package's
    columns, value for value.

    ``band=i`` confines every candidate to ``CLUSTER_BANDS[i]`` (one
    cluster's local traffic); ``band=None`` mixes bands PER CANDIDATE
    (the global eval corpus: every decision ranks candidates across
    bands, where solo models extrapolate poorly). Rows obey the
    ``rebuild_decision`` consistency rules.
    """
    n = int(n_decisions)
    # default_rng rejects negative seed words; 9999 is the mixed-corpus
    # sentinel (cluster bands are small non-negative ints).
    rng = np.random.default_rng((seed, 9999 if band is None else band))
    counts = rng.integers(4, 9, size=n).astype(np.int32)
    k = bucket_candidates(int(counts.max()) if n else 0)
    valid = np.arange(k)[None, :] < counts[:, None]

    if band is None:
        band_of = rng.integers(0, len(CLUSTER_BANDS), size=(n, k))
    else:
        band_of = np.full((n, k), int(band))
    lo = np.zeros((n, k, 3))
    hi = np.zeros((n, k, 3))
    for b, spec in enumerate(CLUSTER_BANDS):
        mask = band_of == b
        for j, key in enumerate(("fail", "free", "limit")):
            lo[..., j] = np.where(mask, spec[key][0], lo[..., j])
            hi[..., j] = np.where(mask, spec[key][1], hi[..., j])

    total = rng.integers(64, 2048, size=n).astype(np.float64)
    child_fin = np.floor(rng.random(n) * total)
    feats = np.empty((n, k, 11), np.float32)
    feats[..., 0] = np.floor(rng.random((n, k)) * total[:, None])
    feats[..., 1] = child_fin[:, None]
    feats[..., 2] = total[:, None]
    feats[..., 3] = rng.integers(20, 500, size=(n, k))
    feats[..., 4] = np.floor(lo[..., 0]
                             + rng.random((n, k)) * (hi[..., 0] - lo[..., 0]))
    feats[..., 5] = np.floor(lo[..., 1]
                             + rng.random((n, k)) * (hi[..., 1] - lo[..., 1]))
    feats[..., 6] = np.floor(lo[..., 2]
                             + rng.random((n, k)) * (hi[..., 2] - lo[..., 2]))
    is_seed = (rng.random((n, k)) < 0.3).astype(np.float32)
    feats[..., 7] = is_seed
    feats[..., 8] = is_seed * (rng.random((n, k)) < 0.8)
    feats[..., 9] = (rng.random((n, k)) < 0.5).astype(np.float32)
    feats[..., 10] = rng.integers(0, 6, size=(n, k))
    feats *= valid[..., None]

    cost = true_piece_cost(feats) * (1.0 + 0.05 * rng.standard_normal((n, k)))
    cost = np.maximum(cost, 1e-3)

    ids = np.char.add("c", np.arange(n * k).astype("U8")).reshape(n, k)
    ids = np.where(valid, ids, "")
    slot = np.broadcast_to(np.arange(k)[None, :], (n, k))
    rank = np.where(valid & (slot < 4), slot, -1).astype(np.int32)
    realized_n = (3 * valid).astype(np.int64)
    realized_cost = np.where(valid, cost, -1.0)
    seq = np.arange(n, dtype=np.int64)
    return ColumnarCorpus({
        "seq": seq,
        "verdict": np.zeros(n, np.uint8),
        "total_piece_count": total.astype(np.int64),
        "n_candidates": counts,
        "outcome_cost": np.zeros(n, np.float64),
        "decided_at": seq * 1000,
        "finalized_at": seq * 1000 + 500,
        "task_id": np.char.add("t", (seq % 50).astype("U4")),
        "peer_id": np.char.add("p", seq.astype("U8")),
        "chosen": ids[:, 0].astype(np.str_),
        "outcome": np.zeros(n, dtype="<U1"),
        "cand_id": ids.astype(np.str_),
        "rank": rank,
        "features": feats,
        "valid": valid,
        "cost_n": (rng.integers(1, 40, size=(n, k)) * valid).astype(np.int64),
        "cost_last": np.where(valid, cost, 0.0),
        "cost_prior_mean": np.where(valid, cost, 0.0),
        "cost_prior_pstd": np.where(valid, cost * 0.1, 0.0),
        "realized_n": realized_n,
        "realized_cost": realized_cost,
    })


def synth_cluster_corpora(n_clusters: int, n_decisions: int, *,
                          seed: int = 0) -> Dict[int, object]:
    """Scheduler-id-keyed heterogeneous cluster corpora, one band each."""
    return {
        sid: synth_federated_corpus(
            n_decisions, seed=seed + sid,
            band=(sid - 1) % len(CLUSTER_BANDS))
        for sid in range(1, n_clusters + 1)
    }


def flip_realized_costs(corpus, scale: float = 10.0):
    """The lying-cluster corpus ("label-flipped/scaled"):
    realized costs mirrored around their midpoint (cheap candidates
    carry expensive labels and vice versa) and scaled ×``scale``. The
    resulting update keeps finite weights and an ordinary norm — only
    the pooled-holdout regression screen catches it."""
    cols = corpus.columns()
    rc = np.array(cols["realized_cost"])
    mask = np.asarray(corpus.valid) & (np.asarray(corpus.realized_n) > 0)
    lo, hi = float(rc[mask].min()), float(rc[mask].max())
    cols["realized_cost"] = np.where(mask, ((lo + hi) - rc) * scale, rc)
    return ColumnarCorpus(cols)


def _kill_local_config(seed: int) -> MLPTrainConfig:
    return MLPTrainConfig(hidden=(16,), epochs=2, batch_size=256,
                          eval_fraction=0.2, seed=seed)


def run_federated_kill(workdir: str, *, seed: int = 0,
                       timeout_s: float = 240.0,
                       device=None) -> Dict[str, object]:
    """SIGKILL a subprocess coordinator mid-round, restart it on the same
    journal, and prove the round commits with the journaled updates
    intact (no journaled cluster retrains). The child
    (``python -m dragonfly2_tpu_torch.train.fedproc``, started with
    fork + exec, never a fork of this process) trains on ``device``
    (``None``: the card)."""
    journal_dir = os.path.join(workdir, "kill-journal")
    counter = os.path.join(workdir, "train_counts.txt")
    round_path = os.path.join(journal_dir, "round_000000.json")
    state_path = os.path.join(journal_dir, "state.json")
    cmd = [
        sys.executable, "-m", "dragonfly2_tpu_torch.train.fedproc",
        "--journal-dir", journal_dir, "--counter-path", counter,
        "--seed", str(seed), "--quorum", "3", "--delays", "0,2.0,4.0",
        "--deadline", "150", "--device", str(default_device(device)),
    ]
    out: Dict[str, object] = {
        "ran": True, "skipped": False, "killed_after_updates": [],
        "resumed": [], "received": [], "committed": False,
        "train_counts": {}, "no_retrain": None, "ok": False, "error": None,
    }
    # stdout is not read while the child runs: a file, not a pipe, so a
    # chatty child can never block on a full pipe.
    log_path = os.path.join(workdir, "fedproc-killed.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                cwd=_ROOT)
    try:
        # Watch the durable journal itself (not stdout): kill once at
        # least two updates are on disk but before the round commits.
        deadline = time.monotonic() + timeout_s / 2
        journaled: List[int] = []
        while time.monotonic() < deadline:
            if os.path.exists(state_path):
                out["error"] = "round committed before the kill landed"
                break
            try:
                with open(round_path) as f:
                    journaled = sorted(
                        int(s) for s in json.load(f).get("updates", {}))
            except (OSError, ValueError):
                journaled = []
            if len(journaled) >= 2:
                break
            if proc.poll() is not None:
                with open(log_path) as f:
                    tail = f.read()[-2000:]
                out["error"] = ("coordinator exited before kill: "
                                f"rc={proc.returncode}: {tail}")
                break
            time.sleep(0.05)
        else:
            out["error"] = "timed out waiting for journaled updates"
    finally:
        proc.kill()
        proc.wait()
    out["killed_after_updates"] = journaled
    if out["error"] is not None:
        return out
    if len(journaled) < 2:
        out["error"] = f"only {len(journaled)} updates journaled before kill"
        return out

    # Restart on the same journal: the round must resume and commit.
    try:
        done = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout_s, cwd=_ROOT)
    except subprocess.TimeoutExpired:
        out["error"] = "resumed coordinator timed out"
        return out
    report = None
    for line in done.stdout.splitlines():
        if line.startswith("FEDPROC COMMITTED "):
            report = json.loads(line[len("FEDPROC COMMITTED "):])
    if report is None:
        out["error"] = (f"resume produced no commit (rc={done.returncode}): "
                        f"{done.stdout[-2000:]}")
        return out
    out["resumed"] = report["resumed"]
    out["received"] = report["received"]
    out["committed"] = report["committed"]

    counts: Dict[str, int] = {}
    try:
        with open(counter) as f:
            for line in f:
                sid = line.split()[0]
                counts[sid] = counts.get(sid, 0) + 1
    except OSError:
        pass
    out["train_counts"] = counts
    # The contract: every update that reached the journal before the
    # kill is reused, not retrained — its cluster trained exactly once
    # across both coordinator lives.
    out["no_retrain"] = all(counts.get(str(sid)) == 1 for sid in journaled)
    out["ok"] = bool(
        report["committed"]
        and sorted(report["resumed"]) == journaled
        and len(report["received"]) >= 3
        and out["no_retrain"])
    if not out["ok"] and out["error"] is None:
        out["error"] = "kill-rung assertions failed"
    return out


def run_federated_bench(*, seed: int = 0, n_decisions: int = 300,
                        eval_decisions: int = 400, rounds: int = 2,
                        include_kill: bool = True,
                        device=None) -> Dict[str, object]:
    """All three rungs on ``device`` (``None``: the card): local fits,
    screens, the gate's candidate builds and the replay A/B's scorers.
    Every consumer-read key exists from birth; ``seconds`` holds each
    rung's wall seconds."""
    from dragonfly2_tpu_torch.inference.scorer import (
        MLEvaluator,
        ParentScorer,
    )
    from dragonfly2_tpu_torch.inference.sidecar import _scorer_from_artifact
    from dragonfly2_tpu_torch.manager import (
        Database,
        FilesystemObjectStore,
        ManagerService,
    )
    from dragonfly2_tpu_torch.manager.validation import ValidationConfig
    from dragonfly2_tpu_torch.scheduler import replay as rp
    from dragonfly2_tpu_torch.scheduler.evaluator import BaseEvaluator
    from dragonfly2_tpu_torch.trainer.federation import (
        FederationConfig,
        FederationCoordinator,
        LocalClusterEndpoint,
    )

    report: Dict[str, object] = {
        "seed": seed,
        "n_decisions": n_decisions,
        "eval_decisions": 0,
        "bounds": {"uplift_factor": FED_UPLIFT_BOUND,
                   "poison_factor": POISON_REGRET_FACTOR,
                   "abs_slack_s": ABS_SLACK_S},
        "clean": {"rounds": [], "gate_state": None, "regret": {},
                  "best_solo_regret": None, "federated_regret": None,
                  "deterministic": None, "ok": None},
        "poisoned": {"rounds": [], "screened_reasons": {},
                     "screens_ok": None, "escalated": [],
                     "quarantined_version": None, "gate_state": None,
                     "regret": None, "within_poison_bound": None,
                     "ok": None},
        "kill": {"ran": False, "skipped": not include_kill, "ok": None,
                 "resumed": [], "committed": None, "no_retrain": None,
                 "error": None},
        "verdict_pass": False,
        "error": None,
        "seconds": {},
    }
    workdir = tempfile.mkdtemp(prefix="df2-fedbench-")
    evaluators: Dict[str, object] = {}
    seconds = report["seconds"]
    try:
        device = default_device(device)
        corpora = synth_cluster_corpora(3, n_decisions, seed=seed)
        eval_corpus = synth_federated_corpus(
            eval_decisions, seed=seed + 7919, band=None)
        eval_events = list(eval_corpus.decisions())
        report["eval_decisions"] = len(eval_events)
        if len(eval_events) < MIN_EVAL_DECISIONS:
            raise RuntimeError(
                f"eval corpus too small: {len(eval_events)}")
        traces = [np.stack([rp._row_array(c) for c in e.candidates])
                  for e in eval_events[:100] if e.candidates]
        datasets = cluster_datasets_from_corpora(corpora)
        # Small batches matter more than epochs here: ~700 rows per
        # cluster at batch 512 would be ~2 SGD steps/epoch and the
        # locals would never leave the mean predictor.
        local = MLPTrainConfig(hidden=(32, 16), epochs=30, batch_size=64,
                               eval_fraction=0.2, seed=seed)

        # -- rung 1: clean fleet -------------------------------------------
        t0 = time.perf_counter()
        manager_clean = ManagerService(
            Database(os.path.join(workdir, "clean.db")),
            FilesystemObjectStore(os.path.join(workdir, "clean-objects")),
            validation=ValidationConfig(), device=device)
        coordinator = FederationCoordinator(
            [LocalClusterEndpoint(ds, local, device) for ds in datasets],
            os.path.join(workdir, "clean-journal"),
            FederationConfig(fed=FederatedConfig(local=local, rounds=rounds),
                             quorum=len(datasets), round_deadline_s=300.0),
            manager=manager_clean, traces=traces, device=device)
        clean_rounds = coordinator.run(rounds)
        report["clean"]["rounds"] = [r.to_dict() for r in clean_rounds]
        active = manager_clean.get_active_model(
            "mlp", scheduler_id=GLOBAL_SCHEDULER_ID)
        report["clean"]["gate_state"] = ("active" if active is not None
                                         else "not-active")
        if active is None:
            raise RuntimeError("clean federated model did not gate-promote")
        evaluators["federated"] = MLEvaluator(
            _scorer_from_artifact(active.artifact, device=device))
        for ds in datasets:
            solo = train_mlp(ds.X, ds.y, local, device, group=LOCAL)
            evaluators[f"solo{ds.scheduler_id}"] = MLEvaluator(ParentScorer(
                solo.model, solo.normalizer, solo.target_norm,
                device=device))
        seconds["clean"] = time.perf_counter() - t0

        # -- rung 2: poisoned fleet ----------------------------------------
        t0 = time.perf_counter()
        flip_sid, nan_sid = 4, 5
        flip_corpus = flip_realized_costs(corpora[1])
        poisoned_datasets = cluster_datasets_from_corpora(
            {**{sid: corpora[sid] for sid in corpora},
             flip_sid: flip_corpus,
             nan_sid: corpora[2]})
        manager_poison = ManagerService(
            Database(os.path.join(workdir, "poison.db")),
            FilesystemObjectStore(os.path.join(workdir, "poison-objects")),
            validation=ValidationConfig(), device=device)
        # The liar has a registered model for quarantine to land on.
        liar_dir = os.path.join(workdir, "liar-artifact")
        liar_ds = next(ds for ds in poisoned_datasets
                       if ds.scheduler_id == flip_sid)
        liar = train_mlp(liar_ds.X, liar_ds.y, local, device, group=LOCAL)
        save_model(liar_dir,
                   mlp_tree(liar.params, liar.normalizer, liar.target_norm),
                   ModelMetadata(model_id="liar", model_type="mlp",
                                 evaluation={"mse": liar.mse},
                                 config={"hidden": list(local.hidden)}))
        manager_poison.create_model(
            model_id="liar", model_type="mlp", host_id="liar", ip="",
            hostname="liar", evaluation={"mse": liar.mse},
            artifact_dir=liar_dir, scheduler_id=flip_sid,
            skip_validation=True)
        fed_poison = FederatedConfig(
            local=local, rounds=rounds, aggregator="trimmed_mean",
            screen_quarantine_rounds=rounds)
        endpoints = []
        for ds in poisoned_datasets:
            endpoints.append(LocalClusterEndpoint(
                ds, local, device,
                poison="nan" if ds.scheduler_id == nan_sid else None))
        poison_coordinator = FederationCoordinator(
            endpoints, os.path.join(workdir, "poison-journal"),
            FederationConfig(fed=fed_poison, quorum=3,
                             round_deadline_s=300.0),
            manager=manager_poison, traces=traces, device=device)
        poison_rounds = poison_coordinator.run(rounds)
        report["poisoned"]["rounds"] = [r.to_dict() for r in poison_rounds]
        report["poisoned"]["screened_reasons"] = {
            str(sid): reason
            for r in poison_rounds for sid, reason in r.screened.items()}
        screens_ok = all(
            flip_sid in r.screened and nan_sid in r.screened
            and r.screened[nan_sid] == "nonfinite"
            and not any(s in r.screened for s in (1, 2, 3))
            for r in poison_rounds)
        report["poisoned"]["screens_ok"] = bool(screens_ok)
        report["poisoned"]["escalated"] = sorted(
            poison_coordinator._escalated)
        liar_rows = [r for r in manager_poison.list_models()
                     if r.scheduler_id == flip_sid and r.type == "mlp"]
        quarantined = [r for r in liar_rows if r.state == "quarantined"]
        report["poisoned"]["quarantined_version"] = (
            quarantined[0].version if quarantined else None)
        active_poison = manager_poison.get_active_model(
            "mlp", scheduler_id=GLOBAL_SCHEDULER_ID)
        report["poisoned"]["gate_state"] = (
            "active" if active_poison is not None else "not-active")
        if active_poison is None:
            raise RuntimeError(
                "poisoned-fleet global model did not gate-promote")
        evaluators["poisoned_global"] = MLEvaluator(
            _scorer_from_artifact(active_poison.artifact, device=device))
        seconds["poisoned"] = time.perf_counter() - t0

        # -- replay A/B across every model ---------------------------------
        t0 = time.perf_counter()
        evaluators["rule"] = BaseEvaluator()
        ab = rp.replay_ab(eval_events, evaluators, seed=seed)
        seconds["ab"] = time.perf_counter() - t0
        report["ab"] = ab
        scored = ab["evaluators"]
        regrets = {name: (scored.get(name) or {}).get("regret_mean_s")
                   for name in evaluators}
        report["clean"]["regret"] = regrets
        report["clean"]["deterministic"] = ab["deterministic"]
        solos = [v for k, v in regrets.items()
                 if k.startswith("solo") and v is not None]
        fed_regret = regrets.get("federated")
        best_solo = min(solos) if solos else None
        report["clean"]["best_solo_regret"] = best_solo
        report["clean"]["federated_regret"] = fed_regret
        clean_ok = (fed_regret is not None and best_solo is not None
                    and fed_regret
                    <= FED_UPLIFT_BOUND * best_solo + ABS_SLACK_S)
        report["clean"]["ok"] = bool(clean_ok and ab["deterministic"])

        poison_regret = regrets.get("poisoned_global")
        report["poisoned"]["regret"] = poison_regret
        within = (poison_regret is not None and fed_regret is not None
                  and poison_regret
                  <= POISON_REGRET_FACTOR * fed_regret + ABS_SLACK_S)
        report["poisoned"]["within_poison_bound"] = bool(within)
        report["poisoned"]["ok"] = bool(
            screens_ok and within
            and flip_sid in poison_coordinator._escalated
            and bool(quarantined))

        # -- rung 3: coordinator kill --------------------------------------
        if include_kill:
            t0 = time.perf_counter()
            kill = run_federated_kill(workdir, seed=seed, device=device)
            report["kill"].update(kill)
            seconds["kill"] = time.perf_counter() - t0
        report["verdict_pass"] = bool(
            report["clean"]["ok"] and report["poisoned"]["ok"]
            and (report["kill"]["ok"] if report["kill"]["ran"] else True))
        return report
    except Exception as exc:  # noqa: BLE001 — the stage must report
        report["error"] = f"{type(exc).__name__}: {exc}"
        report["verdict_pass"] = False
        return report
    finally:
        for ev in evaluators.values():
            close = getattr(ev, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001
                    pass
        shutil.rmtree(workdir, ignore_errors=True)
