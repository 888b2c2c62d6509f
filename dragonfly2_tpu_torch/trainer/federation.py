"""Crash-safe federated round orchestration — port of
``dragonfly2_tpu/trainer/federation.py``.

``train_federated_mlp`` runs every cluster's local fit in one process —
correct math, but a single crash loses the whole round and a single
slow cluster stalls it. :class:`FederationCoordinator` drives the same
screened-aggregation round (the screens and aggregators come from
``train/federated.py`` — one implementation, two callers) across
per-cluster trainer *endpoints* with the failure modes handled
explicitly:

- **Stragglers/deaths**: each endpoint trains in its own worker thread
  with full-jitter retries (``utils/backoff.py``); at the round deadline
  the round commits with whatever arrived, as long as ``quorum`` (K-of-N)
  updates made it. A slow or dead cluster delays nothing past the
  deadline. A straggler's thread may outlive its round; :meth:`drain
  <FederationCoordinator.drain>` waits for it.
- **Coordinator death**: every received update is journaled durably the
  moment it arrives (unique tmp → fsync → ``os.replace`` → dir fsync). A
  SIGKILLed coordinator restarts, replays the journal, asks only the
  MISSING clusters to train, and commits the same round — no received
  update is ever retrained.
- **Commit**: ``state.json`` is the source of truth (global params,
  strike counts, round counter, lineage). It is written atomically
  BEFORE the round file is marked committed, so a crash between the two
  leaves a stale uncommitted round file that the moved-on round counter
  simply ignores.

The journal is byte-compatible with the JAX package's (``JOURNAL_VERSION``
1, ``state.json``, ``round_NNNNNN.json``, parameter trees as leaf paths
and one base64 npz blob), so a journal written by either package resumes
in the other.

The committed aggregate registers under ``GLOBAL_SCHEDULER_ID`` as a
CANDIDATE through the registry's validation gate — a poisoned aggregate
that slips the screens still cannot activate.

Determinism: updates are screened and aggregated in scheduler-id order
regardless of arrival order, so same corpora + seed ⇒ bit-identical
global params whether a round ran clean, resumed from a journal, or
raced its stragglers — given local fits that are deterministic on the
card for equal shapes.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dragonfly2_tpu_torch.inference.modelguard import poison_params
from dragonfly2_tpu_torch.models.mlp import Normalizer, predict_bandwidth
from dragonfly2_tpu_torch.scheduler.replaystore import ColumnarCorpus
from dragonfly2_tpu_torch.train.federated import (
    ClusterDataset,
    ClusterUpdate,
    FederatedConfig,
    FederatedResult,
    aggregate_updates,
    cluster_datasets_from_corpora,
    column_moments,
    escalate_screened_clusters,
    init_global_params,
    normalizer_from_moments,
    register_federated_model,
    screen_updates,
    tree_map,
)
from dragonfly2_tpu_torch.parallel.mesh import LOCAL
from dragonfly2_tpu_torch.train.mlp_trainer import train_mlp
from dragonfly2_tpu_torch.utils.backoff import full_jitter

logger = logging.getLogger(__name__)

JOURNAL_VERSION = 1


class FederationQuorumError(RuntimeError):
    """Round deadline passed with fewer than ``quorum`` updates. The
    journal keeps whatever arrived; the next ``run_round`` resumes."""


# ----------------------------------------------------------------------
# Journal plumbing
# ----------------------------------------------------------------------


def atomic_write_json(path: str, payload: dict) -> None:
    """Crash-atomic publish: unique-per-call tmp name, fsync the tmp
    BEFORE ``os.replace`` (a crash can expose old or new, never torn),
    fsync the parent directory after (the rename itself survives)."""
    directory = os.path.dirname(os.path.abspath(path))
    tmp = os.path.join(directory,
                       f".{os.path.basename(path)}.{uuid.uuid4().hex}.tmp")
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dir_fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def pack_params(tree) -> dict:
    """JSON-safe encoding of a parameter tree: leaf paths + one base64
    npz blob. Float leaves round-trip bit-exactly (the journal must not
    perturb the determinism contract)."""
    paths: List[str] = []
    arrays: List[np.ndarray] = []

    def walk(node, path: str) -> None:
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], f"{path}/{key}" if path else str(key))
            return
        paths.append(path)
        arrays.append(np.asarray(node))

    walk(tree, "")
    buf = io.BytesIO()
    np.savez(buf, **{f"a{i}": arr for i, arr in enumerate(arrays)})
    return {"paths": paths,
            "npz": base64.b64encode(buf.getvalue()).decode("ascii")}


def unpack_params(packed: dict):
    data = np.load(io.BytesIO(base64.b64decode(packed["npz"])))
    if packed["paths"] == [""]:
        return data["a0"]
    tree: dict = {}
    for i, path in enumerate(packed["paths"]):
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = data[f"a{i}"]
    return tree


# ----------------------------------------------------------------------
# Cluster endpoints
# ----------------------------------------------------------------------

# In-process endpoints share the host's card; concurrent train loops
# from worker threads would contend for it (and interleave their
# launches). Sleeps (straggler injection) happen OUTSIDE this lock so
# deadline semantics stay real.
_LOCAL_TRAIN_LOCK = threading.Lock()


class LocalClusterEndpoint:
    """A per-cluster trainer endpoint backed by an in-process dataset.

    The endpoint protocol the coordinator speaks (duck-typed — a gRPC
    stub to a remote trainer implements the same three methods):

    - ``scheduler_id`` — the cluster's registry slot
    - ``moments()`` — ``((n, Σx, Σx²) features, (n, Σt, Σt²) log-target)``
      for exact pooled normalization without shipping rows
    - ``holdout()`` — ``(X, y)`` holdout slice volunteered for the
      pooled regression screen and global eval
    - ``train_round(round_idx, global_params, normalizer, target_norm)``
      → :class:`~dragonfly2_tpu_torch.train.federated.ClusterUpdate`

    Fault injection for tests/bench: ``delay_s`` (straggler),
    ``fail_times`` (transient failures consumed by the retry path),
    ``poison`` ("nan" | "scale" — the lying-cluster attack shapes), and
    ``counter_path`` (append-only file recording every actual local fit,
    how the kill rung proves no journaled cluster retrains). Local fits
    run on ``device`` (``None``: the card).
    """

    def __init__(self, dataset: ClusterDataset, local_config,
                 device=None, *,
                 delay_s: float = 0.0, fail_times: int = 0,
                 poison: Optional[str] = None,
                 counter_path: Optional[str] = None) -> None:
        self.scheduler_id = int(dataset.scheduler_id)
        self._config = local_config
        self._device = device
        self.delay_s = float(delay_s)
        self._failures_left = int(fail_times)
        self.poison = poison
        self.counter_path = counter_path
        self.train_calls = 0

        # Deterministic holdout carve, mirroring train_federated_mlp:
        # same (seed, scheduler_id) rng, holdout capped so the local fit
        # always keeps rows.
        rng = np.random.default_rng((local_config.seed, self.scheduler_id))
        perm = rng.permutation(len(dataset.X))
        fraction = max(local_config.eval_fraction, 0.05)
        n_hold = min(max(int(len(dataset.X) * fraction), 1),
                     max(len(dataset.X) - 4, 0))
        hold, keep = perm[:n_hold], perm[n_hold:]
        self._hold = (dataset.X[hold], dataset.y[hold])
        self._train_X, self._train_y = dataset.X[keep], dataset.y[keep]

    def moments(self):
        return (column_moments(self._train_X),
                column_moments(np.log1p(self._train_y)[:, None]))

    def holdout(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._hold

    def train_round(self, round_idx: int, global_params,
                    normalizer: Normalizer,
                    target_norm: Normalizer) -> ClusterUpdate:
        if self.delay_s:
            time.sleep(self.delay_s)
        if self._failures_left > 0:
            self._failures_left -= 1
            raise RuntimeError(
                f"cluster {self.scheduler_id}: injected transient failure")
        with _LOCAL_TRAIN_LOCK:
            result = train_mlp(
                self._train_X, self._train_y, self._config, self._device,
                init_params=global_params,
                normalizer=normalizer, target_norm=target_norm,
                group=LOCAL)
        self.train_calls += 1
        if self.counter_path:
            # Append + fsync: the kill rung reads this across process
            # lifetimes to prove journaled clusters never retrain.
            with open(self.counter_path, "a") as f:
                f.write(f"{self.scheduler_id} {round_idx}\n")
                f.flush()
                os.fsync(f.fileno())
        params = result.params
        if self.poison == "nan":
            params = poison_params(params, "nan")
        elif self.poison == "scale":
            params = tree_map(
                lambda leaf: np.asarray(leaf) * 1000.0, params)
        elif self.poison is not None:
            raise ValueError(f"unknown poison mode {self.poison!r}")
        return ClusterUpdate(self.scheduler_id, params, len(self._train_X))


# ----------------------------------------------------------------------
# Coordinator
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class FederationConfig:
    """Round-orchestration knobs; the screening/aggregation knobs ride
    in ``fed`` (one ``FederatedConfig``, shared with
    ``train_federated_mlp``)."""

    fed: FederatedConfig = FederatedConfig()
    #: K-of-N: a round commits with at least this many received updates.
    quorum: int = 2
    #: Straggler deadline per round attempt, seconds.
    round_deadline_s: float = 60.0
    #: Transient-failure retries per endpoint per round (full jitter).
    retry_limit: int = 2
    retry_base_s: float = 0.05
    retry_cap_s: float = 1.0
    model_id: str = "df2-mlp-global"


@dataclass
class RoundReport:
    round: int
    received: List[int] = field(default_factory=list)
    resumed: List[int] = field(default_factory=list)
    stragglers: List[int] = field(default_factory=list)
    screened: Dict[int, str] = field(default_factory=dict)
    admitted: List[int] = field(default_factory=list)
    escalated: List[int] = field(default_factory=list)
    quorum: int = 0
    committed: bool = False
    registered_state: Optional[str] = None
    duration_s: float = 0.0

    def to_dict(self) -> dict:
        return {
            "round": self.round,
            "received": list(self.received),
            "resumed": list(self.resumed),
            "stragglers": list(self.stragglers),
            "screened": {str(k): v for k, v in self.screened.items()},
            "admitted": list(self.admitted),
            "escalated": list(self.escalated),
            "quorum": self.quorum,
            "committed": self.committed,
            "registered_state": self.registered_state,
            "duration_s": self.duration_s,
        }


class FederationCoordinator:
    """Drives screened federated rounds across cluster endpoints with a
    durable journal (module docstring has the failure-mode contract).
    The holdout screen and :meth:`result`'s metrics run the bf16 MLP on
    ``device`` (``None``: the card)."""

    def __init__(self, endpoints: Sequence, journal_dir: str,
                 config: FederationConfig = FederationConfig(), *,
                 manager=None, traces=None, device=None) -> None:
        self.endpoints = sorted(endpoints, key=lambda e: e.scheduler_id)
        if not self.endpoints:
            raise ValueError("no cluster endpoints")
        sids = [e.scheduler_id for e in self.endpoints]
        if len(set(sids)) != len(sids):
            raise ValueError(f"duplicate scheduler ids in endpoints: {sids}")
        if config.quorum < 1 or config.quorum > len(self.endpoints):
            raise ValueError(
                f"quorum {config.quorum} outside [1, {len(self.endpoints)}]")
        self.config = config
        self.journal_dir = journal_dir
        self.manager = manager
        self.traces = traces
        os.makedirs(journal_dir, exist_ok=True)
        self._lock = threading.Lock()
        # Worker threads of past rounds that may still run, for drain().
        self._workers: List[threading.Thread] = []

        # Pooled normalization + screening holdout from endpoint-shipped
        # moments/slices, in scheduler-id order — deterministic, and
        # recomputed identically on a resume (the data did not move).
        feat_moments, target_moments, hold_X, hold_y = [], [], [], []
        for ep in self.endpoints:
            fm, tm = ep.moments()
            feat_moments.append(fm)
            target_moments.append(tm)
            hx, hy = ep.holdout()
            if len(hx):
                hold_X.append(np.asarray(hx))
                hold_y.append(np.asarray(hy))
        self.normalizer = normalizer_from_moments(feat_moments)
        self.target_norm = normalizer_from_moments(target_moments)
        # The screen scores per-slice (median over slices defuses a
        # lying endpoint's poisoned holdout rows); result() metrics pool.
        self.holdout_slices = list(zip(hold_X, hold_y))
        self.holdout = ((np.concatenate(hold_X), np.concatenate(hold_y))
                        if hold_X else
                        (np.empty((0, len(self.normalizer.mean)),
                                  np.float32), np.empty((0,), np.float32)))

        feature_dim = int(np.asarray(feat_moments[0][1]).shape[0])
        self._model, init_params = init_global_params(
            config.fed.local.hidden, feature_dim, config.fed.local.seed,
            device)

        self.stats = {"rounds_committed": 0, "updates_received": 0,
                      "updates_resumed": 0, "updates_screened": 0,
                      "quorum_failures": 0, "escalations": 0}
        state = self._load_state()
        if state is not None:
            self.next_round = int(state["next_round"])
            self.global_params = (unpack_params(state["global_params"])
                                  if state.get("global_params") else
                                  init_params)
            self._strikes = {int(k): int(v)
                             for k, v in state.get("strikes", {}).items()}
            self._escalated = [int(s) for s in state.get("escalated", [])]
            self._lineage = [{int(k): int(v) for k, v in contrib.items()}
                             for contrib in state.get("lineage", [])]
            self._screened_hist = [
                {int(k): v for k, v in s.items()}
                for s in state.get("screened", [])]
            self.stats["updates_screened"] = int(
                state.get("updates_screened", 0))
            self.stats["rounds_committed"] = int(
                state.get("rounds_committed", 0))
            logger.info("federation journal %s: resuming at round %d",
                        journal_dir, self.next_round)
        else:
            self.next_round = 0
            self.global_params = init_params
            self._strikes: Dict[int, int] = {}
            self._escalated: List[int] = []
            self._lineage: List[Dict[int, int]] = []
            self._screened_hist: List[Dict[int, str]] = []

    # -- journal --------------------------------------------------------

    def _state_path(self) -> str:
        return os.path.join(self.journal_dir, "state.json")

    def _round_path(self, round_idx: int) -> str:
        return os.path.join(self.journal_dir, f"round_{round_idx:06d}.json")

    def _load_state(self) -> Optional[dict]:
        try:
            with open(self._state_path()) as f:
                state = json.load(f)
        except FileNotFoundError:
            return None
        if state.get("version") != JOURNAL_VERSION:
            raise ValueError(
                f"federation journal version {state.get('version')} != "
                f"{JOURNAL_VERSION}")
        return state

    def _write_state(self) -> None:
        atomic_write_json(self._state_path(), {
            "version": JOURNAL_VERSION,
            "next_round": self.next_round,
            "global_params": pack_params(self.global_params),
            "strikes": {str(k): v for k, v in self._strikes.items()},
            "escalated": list(self._escalated),
            "lineage": [{str(k): v for k, v in contrib.items()}
                        for contrib in self._lineage],
            "screened": [{str(k): v for k, v in s.items()}
                         for s in self._screened_hist],
            "updates_screened": self.stats["updates_screened"],
            "rounds_committed": self.stats["rounds_committed"],
        })

    def _load_round(self, round_idx: int) -> dict:
        try:
            with open(self._round_path(round_idx)) as f:
                journal = json.load(f)
        except FileNotFoundError:
            return {"version": JOURNAL_VERSION, "round": round_idx,
                    "committed": False, "updates": {}}
        if journal.get("version") != JOURNAL_VERSION:
            raise ValueError("federation round journal version mismatch")
        return journal

    # -- round ----------------------------------------------------------

    def run_round(self) -> RoundReport:
        """One quorum-committed round; resumes the journaled one if the
        previous attempt died mid-round."""
        start = time.monotonic()
        round_idx = self.next_round
        journal = self._load_round(round_idx)
        resumed = sorted(int(s) for s in journal["updates"])
        if resumed:
            self.stats["updates_resumed"] += len(resumed)
            logger.info("round %d: resumed %d journaled updates (%s)",
                        round_idx, len(resumed), resumed)

        pending = [ep for ep in self.endpoints
                   if str(ep.scheduler_id) not in journal["updates"]]
        deadline = start + self.config.round_deadline_s
        all_received = threading.Event()
        if not pending:
            all_received.set()

        def worker(ep) -> None:
            rng = np.random.default_rng(
                (self.config.fed.local.seed, round_idx, ep.scheduler_id))
            for attempt in range(self.config.retry_limit + 1):
                if time.monotonic() >= deadline:
                    return
                try:
                    update = ep.train_round(
                        round_idx, self.global_params,
                        self.normalizer, self.target_norm)
                except Exception as exc:  # noqa: BLE001 — retry path
                    logger.warning("round %d cluster %d attempt %d: %s",
                                   round_idx, ep.scheduler_id, attempt, exc)
                    delay = full_jitter(attempt, self.config.retry_base_s,
                                        self.config.retry_cap_s, rng)
                    time.sleep(min(delay, max(deadline - time.monotonic(),
                                              0.0)))
                    continue
                with self._lock:
                    if journal.get("committed"):
                        return  # straggler finished after the commit
                    journal["updates"][str(update.scheduler_id)] = {
                        "params": pack_params(update.params),
                        "n": int(update.n_samples),
                        "received_at": time.time(),
                    }
                    # Durable the moment it arrives: this is the update
                    # a SIGKILLed coordinator must NOT retrain.
                    atomic_write_json(self._round_path(round_idx), journal)
                    self.stats["updates_received"] += 1
                    if len(journal["updates"]) >= len(self.endpoints):
                        all_received.set()
                return
            logger.warning("round %d cluster %d: retries exhausted",
                           round_idx, ep.scheduler_id)

        threads = [threading.Thread(target=worker, args=(ep,), daemon=True,
                                    name=f"fed-ep-{ep.scheduler_id}")
                   for ep in pending]
        self._workers = [t for t in self._workers if t.is_alive()] + threads
        for t in threads:
            t.start()
        while time.monotonic() < deadline and not all_received.is_set():
            all_received.wait(timeout=min(
                0.02, max(deadline - time.monotonic(), 0.0)))

        with self._lock:
            received = dict(journal["updates"])
            if len(received) >= self.config.quorum:
                journal["committed"] = True  # blocks post-commit writers

        report = RoundReport(
            round=round_idx,
            received=sorted(int(s) for s in received),
            resumed=resumed,
            stragglers=sorted(ep.scheduler_id for ep in self.endpoints
                              if str(ep.scheduler_id) not in received),
            quorum=self.config.quorum,
        )
        if len(received) < self.config.quorum:
            self.stats["quorum_failures"] += 1
            report.duration_s = time.monotonic() - start
            raise FederationQuorumError(
                f"round {round_idx}: {len(received)} updates < quorum "
                f"{self.config.quorum} at deadline "
                f"(journal keeps them; next run_round resumes)")

        # Screen + aggregate in scheduler-id order: bit-identical params
        # regardless of arrival order or resume history.
        updates = [
            ClusterUpdate(int(sid), unpack_params(rec["params"]),
                          int(rec["n"]))
            for sid, rec in sorted(received.items(), key=lambda kv:
                                   int(kv[0]))
        ]
        screen = screen_updates(
            updates, self.global_params, config=self.config.fed,
            model=self._model, normalizer=self.normalizer,
            target_norm=self.target_norm,
            holdout=self.holdout_slices or None)
        newly_escalated: List[int] = []
        for update in updates:
            sid = update.scheduler_id
            if sid in screen.screened:
                self._strikes[sid] = self._strikes.get(sid, 0) + 1
                if (self.config.fed.screen_quarantine_rounds > 0
                        and self._strikes[sid]
                        >= self.config.fed.screen_quarantine_rounds
                        and sid not in self._escalated):
                    self._escalated.append(sid)
                    newly_escalated.append(sid)
            else:
                self._strikes[sid] = 0
        self.stats["updates_screened"] += len(screen.screened)
        self._screened_hist.append(dict(screen.screened))
        if screen.admitted:
            self.global_params = aggregate_updates(
                screen.admitted, self.config.fed.aggregator,
                self.config.fed.trim_fraction)
            self._lineage.append({u.scheduler_id: u.n_samples
                                  for u in screen.admitted})
        else:
            self._lineage.append({})
            logger.warning("round %d: ALL updates screened (%s); global "
                           "params unchanged", round_idx, screen.screened)

        if newly_escalated and self.manager is not None:
            escalate_screened_clusters(self.manager, newly_escalated)
            self.stats["escalations"] += len(newly_escalated)

        # Commit order matters: state.json (source of truth) FIRST, then
        # the round file's committed marker. A crash between the two
        # leaves a stale uncommitted round file that the advanced round
        # counter never revisits.
        self.next_round = round_idx + 1
        self.stats["rounds_committed"] += 1
        self._write_state()
        with self._lock:
            journal["committed"] = True
            journal["screened"] = {str(k): v
                                   for k, v in screen.screened.items()}
            journal["admitted"] = [u.scheduler_id for u in screen.admitted]
            atomic_write_json(self._round_path(round_idx), journal)

        report.screened = dict(screen.screened)
        report.admitted = [u.scheduler_id for u in screen.admitted]
        report.escalated = newly_escalated
        report.committed = True
        if self.manager is not None:
            row = register_federated_model(
                self.manager, self.result(), model_id=self.config.model_id,
                traces=self.traces)
            report.registered_state = getattr(row, "state", None)
        report.duration_s = time.monotonic() - start
        logger.info("round %d committed: %d received (%d resumed), "
                    "%d admitted, %d screened, %.2fs",
                    round_idx, len(report.received), len(report.resumed),
                    len(report.admitted), len(report.screened),
                    report.duration_s)
        return report

    def drain(self, timeout: float | None = None) -> bool:
        """Wait for the worker threads of past rounds — a straggler that
        outlived its round's deadline may still be inside a local fit on
        the card. Returns True when none is left running. The round's
        commit semantics do not change: a straggler that finishes after
        the commit is dropped, one that finishes after a quorum failure
        is journaled for the next ``run_round``."""
        end = None if timeout is None else time.monotonic() + timeout
        for t in self._workers:
            t.join(None if end is None else max(end - time.monotonic(), 0.0))
        self._workers = [t for t in self._workers if t.is_alive()]
        return not self._workers

    def run(self, rounds: int) -> List[RoundReport]:
        """Run until ``rounds`` total rounds have committed (counting
        rounds committed by previous lives of this journal)."""
        reports = []
        while self.stats["rounds_committed"] < rounds:
            reports.append(self.run_round())
        return reports

    def result(self) -> FederatedResult:
        """The coordinator's state as a FederatedResult — what registers
        through the gate. mse/mae come from the pooled holdout."""
        mse = mae = float("nan")
        if len(self.holdout[0]):
            pred = predict_bandwidth(
                self._model, self.global_params, self.normalizer,
                self.target_norm, self.holdout[0])
            err = pred - self.holdout[1]
            mse = float((err**2).mean())
            mae = float(np.abs(err).mean())
        return FederatedResult(
            params=self.global_params,
            normalizer=self.normalizer,
            target_norm=self.target_norm,
            config=self.config.fed,
            mse=mse, mae=mae,
            lineage=list(self._lineage),
            screened=list(self._screened_hist),
            updates_screened=self.stats["updates_screened"],
            escalated=list(self._escalated),
        )


def endpoints_from_storage(storage, host_identities: Dict,
                           local_config, device=None
                           ) -> List[LocalClusterEndpoint]:
    """Build per-cluster endpoints from the trainer's own replay
    segments (``TrainerStorage.list_replay``). ``host_identities`` maps
    host id → ``(ip, hostname, scheduler_id)``; hosts sharing a
    scheduler_id pool their decisions into one cluster dataset; clusters
    with no realized replay examples are skipped."""

    by_cluster: Dict[int, list] = {}
    for host_id, (_ip, _hostname, scheduler_id) in host_identities.items():
        events = storage.list_replay(host_id)
        if events:
            by_cluster.setdefault(int(scheduler_id), []).extend(events)
    corpora = {sid: ColumnarCorpus.from_events(events)
               for sid, events in by_cluster.items()}
    datasets = cluster_datasets_from_corpora(corpora)
    return [LocalClusterEndpoint(ds, local_config, device)
            for ds in datasets]
