"""Parent-peer evaluation — port of ``dragonfly2_tpu/scheduler/evaluator``
(upstream: scheduler/scheduling/evaluator/).

Four algorithms, as in the reference's factory (evaluator.go:36-57 —
``default`` | ``ml`` | ``plugin``, plus the learned ``cost``):

- :class:`~dragonfly2_tpu_torch.scheduler.evaluator.base.BaseEvaluator` —
  the rule-based score math (evaluator_base.go:32-247), also the
  fallback of the learned evaluators;
- ``MLEvaluator`` (:mod:`dragonfly2_tpu_torch.inference.scorer`) — ranks
  by the bandwidth predictor's scores (the ``MLAlgorithm`` TODO,
  evaluator.go:48);
- ``LearnedCostEvaluator`` (same module) — ranks by predicted piece cost
  and judges bad nodes against it;
- plugins from the ``dragonfly2_tpu_torch.evaluator`` entry-point group.
"""

from dragonfly2_tpu_torch.scheduler.evaluator.base import BaseEvaluator
from dragonfly2_tpu_torch.scheduler.evaluator.scoring import (
    FEATURE_DIM,
    FEATURE_NAMES,
    idc_match,
    location_matches,
    rule_scores,
)

ALGORITHM_DEFAULT = "default"
ALGORITHM_ML = "ml"
ALGORITHM_COST = "cost"
ALGORITHM_PLUGIN = "plugin"

#: Entry-point group of evaluator plugins (the JAX package's is
#: ``dragonfly2_tpu.evaluator``; each package loads its own).
PLUGIN_GROUP = "dragonfly2_tpu_torch.evaluator"


def new_evaluator(algorithm: str = ALGORITHM_DEFAULT, *, scorer=None,
                  sidecar_target: str | None = None,
                  micro_batch: bool = False,
                  batch_adaptive_wait_s: float = 0.0005,
                  batch_lanes: int = 1,
                  batch_queue_depth: int = 0,
                  **guard_kwargs):
    """Evaluator factory (evaluator.go:36-57 New).

    ``ml``: an in-process :class:`MLEvaluator` over ``scorer`` (``None``
    ranks by rules). ``micro_batch`` fronts the scorer with a
    :class:`~dragonfly2_tpu_torch.inference.batcher.MicroBatcher`, so
    concurrent scheduling threads share device dispatches; ``batch_lanes``
    shards it into independent lanes and ``batch_queue_depth`` bounds each
    lane's queue (0 = unbounded). A shed request is ranked by the rule
    evaluator and counted in ``shed_count``. The caller owns the
    batcher: call ``evaluator.close()`` on teardown or model swap.
    ``cost``: a :class:`LearnedCostEvaluator`; it needs a ``CostScorer``
    (``inference.sidecar._cost_scorer_from_artifact``) and raises
    without one. ``plugin``: the first entry point of
    :data:`PLUGIN_GROUP`. Anything else: :class:`BaseEvaluator`.
    ``guard_kwargs`` go to the evaluator's constructor.

    The sidecar-backed evaluator (``sidecar_target``) needs the gRPC
    transport, which is not ported yet (ROADMAP.md Queue 1 item 4, the
    transport slice): it raises NotImplementedError rather than fall
    back silently.
    """
    if sidecar_target:
        raise NotImplementedError(
            "sidecar_target: the gRPC transport (InferenceClient, "
            "RemoteMLEvaluator) is not ported yet (ROADMAP.md Queue 1 "
            "item 4, the transport slice)")
    if algorithm == ALGORITHM_ML:
        from dragonfly2_tpu_torch.inference.scorer import MLEvaluator

        if micro_batch and scorer is not None:
            from dragonfly2_tpu_torch.inference.batcher import MicroBatcher

            scorer = MicroBatcher(
                scorer, adaptive_wait_s=batch_adaptive_wait_s,
                lanes=batch_lanes, queue_depth=batch_queue_depth)
        return MLEvaluator(scorer, **guard_kwargs)
    if algorithm == ALGORITHM_COST:
        from dragonfly2_tpu_torch.inference.scorer import LearnedCostEvaluator

        if scorer is None:
            raise ValueError(
                "algorithm 'cost' needs a CostScorer (build one from a "
                "'cost' model artifact with _cost_scorer_from_artifact)")
        return LearnedCostEvaluator(scorer, **guard_kwargs)
    if algorithm == ALGORITHM_PLUGIN:
        from importlib.metadata import entry_points

        for ep in entry_points(group=PLUGIN_GROUP):
            return ep.load()()
        raise ValueError("no evaluator plugin installed")
    return BaseEvaluator()


__all__ = [
    "ALGORITHM_COST",
    "ALGORITHM_DEFAULT",
    "ALGORITHM_ML",
    "ALGORITHM_PLUGIN",
    "BaseEvaluator",
    "FEATURE_DIM",
    "FEATURE_NAMES",
    "PLUGIN_GROUP",
    "idc_match",
    "location_matches",
    "new_evaluator",
    "rule_scores",
]
