"""How far the port's ``ring_attention`` (the JAX package's algebra, in
bf16) sits from plain f32 attention, row by row as ``chip_smoke.py``'s
ring_attention phase checks it, and how far a wrong mask puts it: the
margin behind that phase's RING_ATT_TOL.

    python3 tests/ring_attention_tolerance.py [--device cuda] [--t 2048]

A world of one (the algebra is the same on every rank), causal, 8 heads
of 8, the last 5 % of keys masked out: the clean run, a run that drops
one key in 512, and one that ignores ``kv_valid``. Prints one JSON line
a case with ``k3_errors``' row errors of out, dq, dk and dv.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--t", type=int, default=2048)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from dragonfly2_tpu_torch.parallel import ring_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=args.device).manual_seed(smoke.SEED + 5)
    t = args.t
    q, k, v, dout = (torch.randn(t, 8, 8, generator=gen,
                                 device=args.device).to(torch.bfloat16)
                     for _ in range(4))
    keys = torch.arange(t, device=args.device)
    valid = keys < int(t * (1 - smoke.RING_ATT_MASKED))
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    ref_out = smoke.dense_attention(torch, *leaves, True, valid)
    ref = (ref_out.detach(),
           *torch.autograd.grad(ref_out, leaves, dout.float()))
    cases = {"clean": valid, "one_key_in_512_dropped": valid & (keys % 512
                                                               != 7),
             "kv_valid_ignored": None}
    for name, mask in cases.items():
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = ring_attention(*leaves, causal=True, kv_valid=mask)
        got = (out.detach(), *torch.autograd.grad(out, leaves, dout))
        errs = smoke.k3_errors(torch, got, ref)
        print(json.dumps({"case": name, "t": t, "device": args.device,
                          "errors": errs, "tol": smoke.RING_ATT_TOL}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
