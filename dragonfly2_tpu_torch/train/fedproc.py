"""Subprocess coordinator of the federated kill rung — port of
``dragonfly2_tpu/train/fedproc.py``
(``python -m dragonfly2_tpu_torch.train.fedproc``).

Runs ONE quorum-committed federated round over deterministic synthetic
cluster corpora (``train/fedbench.py`` generators, same seed ⇒ same data
in every process life) with staggered endpoint delays, journaling to
``--journal-dir``, local fits on ``--device`` (default ``cuda``). The
parent SIGKILLs the first life mid-round once updates are durably
journaled, then reruns the identical command: this process must resume
from the journal, train only the missing clusters (every completed local
fit appends to ``--counter-path``), and print the committed round
report.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("df2-fedproc")
    parser.add_argument("--journal-dir", required=True)
    parser.add_argument("--counter-path", required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--clusters", type=int, default=3)
    parser.add_argument("--decisions", type=int, default=240)
    parser.add_argument("--quorum", type=int, default=3)
    parser.add_argument("--deadline", type=float, default=150.0)
    parser.add_argument("--delays", default="",
                        help="comma-separated per-cluster straggler "
                             "delays, seconds")
    parser.add_argument("--device", default="cuda",
                        help="where the local fits and screens run")
    args = parser.parse_args(argv)

    from dragonfly2_tpu_torch.train.fedbench import (
        _kill_local_config,
        synth_cluster_corpora,
    )
    from dragonfly2_tpu_torch.train.federated import (
        FederatedConfig,
        cluster_datasets_from_corpora,
    )
    from dragonfly2_tpu_torch.parallel.mesh import LOCAL
    from dragonfly2_tpu_torch.train.mlp_trainer import train_mlp
    from dragonfly2_tpu_torch.trainer.federation import (
        FederationConfig,
        FederationCoordinator,
        LocalClusterEndpoint,
    )

    corpora = synth_cluster_corpora(args.clusters, args.decisions,
                                    seed=args.seed)
    datasets = cluster_datasets_from_corpora(corpora)
    delays = ([float(d) for d in args.delays.split(",")] if args.delays
              else [0.0] * len(datasets))
    local = _kill_local_config(args.seed)
    # One throwaway fit first: the device's context, its library handles
    # and the kernels load here, not inside the round, so the endpoints'
    # delays — not start-up — set when each update reaches the journal.
    train_mlp(datasets[0].X, datasets[0].y, local, args.device,
              group=LOCAL)
    endpoints = [
        LocalClusterEndpoint(ds, local, args.device,
                             delay_s=delays[i % len(delays)],
                             counter_path=args.counter_path)
        for i, ds in enumerate(datasets)
    ]
    coordinator = FederationCoordinator(
        endpoints, args.journal_dir,
        FederationConfig(fed=FederatedConfig(local=local),
                         quorum=args.quorum,
                         round_deadline_s=args.deadline),
        device=args.device)
    print("FEDPROC READY", flush=True)
    report = coordinator.run_round()
    # A straggler past the commit may still be training: let it finish
    # before the interpreter tears the device down.
    coordinator.drain()
    print("FEDPROC COMMITTED " + json.dumps(report.to_dict()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
