"""The host cost of one RPC, both stacks on one host: the JAX package's
gRPC transport and the port's wire (``dragonfly2_tpu_torch/rpc``), each
serving its own inference service on loopback.

    JAX_PLATFORMS=cpu python tests/rpc_call_cost.py [--calls 2000]

Per stack: an empty unary call (the health service's Check) and a 64-row
ModelInfer on an MLP at config #1's widths (random weights from seed 0,
served by each package's scorer on the CPU behind its default
micro-batcher), each over ``--calls`` sequential calls after 50 warm-up
calls; the same ModelInfer called in process gives the transport's share.
Prints one JSON object: p50/p99 µs per call, the host's CPU count. The
figures are the CPU host's: the card plays no part in them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def percentiles_us(call, calls: int) -> dict:
    for _ in range(50):
        call()
    us = []
    for _ in range(calls):
        t0 = time.perf_counter()
        call()
        us.append((time.perf_counter() - t0) * 1e6)
    us.sort()
    return {"calls": calls, "p50_us": us[calls // 2],
            "p99_us": us[min(int(calls * 0.99), calls - 1)]}


def jax_stack(x, calls: int) -> dict:
    import jax

    from dragonfly2_tpu.inference import scorer, sidecar
    from dragonfly2_tpu.models.mlp import MLPBandwidthPredictor, Normalizer
    from dragonfly2_tpu.rpc import ServiceClient, serve
    from dragonfly2_tpu.rpc.health import HEALTH_SPEC, HealthCheckRequest

    params = jax.device_get(MLPBandwidthPredictor().init(
        jax.random.key(0), x[:2]))
    service = sidecar.InferenceService()
    service.install_scorer("mlp", scorer.ParentScorer(
        MLPBandwidthPredictor(), params, Normalizer.fit(x),
        Normalizer(np.array([2.5], np.float32),
                   np.array([0.7], np.float32))), version="v")
    server = serve([(sidecar.INFERENCE_SPEC, service)])
    health = ServiceClient(server.target, HEALTH_SPEC)
    client = sidecar.InferenceClient(server.target, timeout=30)
    ctx = type("Ctx", (), {"abort": lambda self, c, d: None})()
    try:
        return {
            "empty_unary": percentiles_us(
                lambda: health.Check(HealthCheckRequest(), timeout=30),
                calls),
            "model_infer_64": percentiles_us(
                lambda: client.model_infer_full("mlp", x), calls),
            "model_infer_64_in_process": percentiles_us(
                lambda: service.ModelInfer(
                    sidecar.ModelInferRequest("mlp", x), ctx), calls)}
    finally:
        client.close()
        health.close()
        server.stop()
        service.stop()


def port_stack(x, calls: int) -> dict:
    import torch

    from dragonfly2_tpu_torch.inference import sidecar
    from dragonfly2_tpu_torch.inference.scorer import ParentScorer
    from dragonfly2_tpu_torch.models.mlp import (
        MLPBandwidthPredictor,
        Normalizer,
    )
    from dragonfly2_tpu_torch.rpc import ServiceClient, serve
    from dragonfly2_tpu_torch.rpc.health import (
        HEALTH_SPEC,
        HealthCheckRequest,
    )

    model = MLPBandwidthPredictor(
        generator=torch.Generator().manual_seed(0))
    service = sidecar.InferenceService()
    service.install_scorer("mlp", ParentScorer(
        model, Normalizer.fit(x),
        Normalizer(np.array([2.5], np.float32),
                   np.array([0.7], np.float32)), device="cpu"),
        version="v")
    server = serve([(sidecar.INFERENCE_SPEC, service)])
    health = ServiceClient(server.target, HEALTH_SPEC)
    client = sidecar.InferenceClient(server.target, timeout=30)
    ctx = sidecar.CallContext()
    try:
        return {
            "empty_unary": percentiles_us(
                lambda: health.Check(HealthCheckRequest(), timeout=30),
                calls),
            "model_infer_64": percentiles_us(
                lambda: client.model_infer_full("mlp", x), calls),
            "model_infer_64_in_process": percentiles_us(
                lambda: service.ModelInfer(
                    sidecar.ModelInferRequest("mlp", x), ctx), calls)}
    finally:
        client.close()
        server.stop()
        service.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("rpc_call_cost")
    parser.add_argument("--calls", type=int, default=2000)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    x = np.random.default_rng(0).uniform(0, 100, (64, 11)).astype(
        np.float32)
    out = {"host_cpus": os.cpu_count(), "rows": 64,
           "port_wire": port_stack(x, args.calls),
           "jax_grpc": jax_stack(x, args.calls)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
