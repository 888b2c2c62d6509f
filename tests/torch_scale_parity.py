"""Gather-mode training of the JAX package and the port side by side at a
size between the unit tests and config #3, on the CPU, from one flax init
(and once more from the port's own seeded init). Prints one JSON line per
run: per-epoch losses, F1 and accuracy.

    JAX_PLATFORMS=cpu python tests/torch_scale_parity.py [hosts probes batch epochs]

Defaults: 2000 hosts, 60 000 probes, batch 2048, 2 epochs, config #3's
widths (hidden 128, embed 64, 2 layers, 4 heads, neighbor cap 64). Takes
about a minute.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import conftest  # noqa: E402,F401  (JAX on the CPU, as the tests run it)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dragonfly2_tpu.data import SyntheticCluster as JaxCluster  # noqa: E402
from dragonfly2_tpu.models.graph_transformer import (  # noqa: E402
    GraphTransformer as JaxGT,
    build_neighbor_lists,
    pad_graph_sparse,
)
from dragonfly2_tpu.parallel import data_parallel_mesh  # noqa: E402
from dragonfly2_tpu.train import gat_trainer as jax_gat_trainer  # noqa: E402
from dragonfly2_tpu.train.gnn_trainer import edge_split  # noqa: E402
from dragonfly2_tpu_torch.data import SyntheticCluster  # noqa: E402
from dragonfly2_tpu_torch.train.checkpoint import (  # noqa: E402
    gat_state_dict_from_flax,
)
from dragonfly2_tpu_torch.train.gat_trainer import (  # noqa: E402
    GATTrainConfig,
    train_gat,
)


def main(hosts=2000, probes=60_000, batch=2048, epochs=2) -> None:
    cfg = dict(hidden=128, embed=64, layers=2, heads=4, neighbor_cap=64,
               edge_batch_size=batch, eval_fraction=0.02, epochs=epochs)
    jg = JaxCluster(n_hosts=hosts, seed=0).probe_graph(probes)
    tg = SyntheticCluster(n_hosts=hosts, seed=0).probe_graph(probes)

    def report(name, t0, result):
        print(json.dumps({"run": name, "seconds": time.perf_counter() - t0,
                          "history": result.history, "f1": result.f1,
                          "accuracy": result.accuracy, **cfg}), flush=True)

    jcfg = jax_gat_trainer.GATTrainConfig(**cfg)
    t0 = time.perf_counter()
    report("jax", t0, jax_gat_trainer.train_gat(
        jg, jcfg, data_parallel_mesh(jax.devices()[:1])))

    train_ids, _ = edge_split(jg, jcfg.eval_fraction, jcfg.seed)
    nbr, val = build_neighbor_lists(
        jg.n_nodes, jg.edge_src[train_ids], jg.edge_dst[train_ids],
        jg.edge_rtt_ns[train_ids], cap=jcfg.neighbor_cap)
    feats, nbr, val, _ = pad_graph_sparse(jg.node_features, nbr, val, 1)
    init = JaxGT(hidden=jcfg.hidden, embed=jcfg.embed, layers=jcfg.layers,
                 heads=jcfg.heads).init(
        jax.random.key(jcfg.seed), jnp.asarray(feats), jnp.asarray(nbr),
        jnp.asarray(val), jnp.zeros(2, jnp.int32), jnp.zeros(2, jnp.int32))
    state = gat_state_dict_from_flax(jax.device_get(init))
    t0 = time.perf_counter()
    report("port_flax_init", t0, train_gat(tg, GATTrainConfig(**cfg),
                                           device="cpu", init_state=state))
    t0 = time.perf_counter()
    report("port_seeded_init", t0, train_gat(tg, GATTrainConfig(**cfg),
                                             device="cpu"))


if __name__ == "__main__":
    main(*map(int, sys.argv[1:5]))
