"""The RPC plane without grpc — port of ``dragonfly2_tpu/rpc``.

The JAX package keeps real gRPC with messages defined as registered
dataclasses and a compact binary codec. The port keeps the same specs,
the same codec bytes and gRPC's status semantics over a framing of its
own on the standard library's sockets (``wire.py``), so the services run
where grpcio is not installed.

- codec:      message registry + encode/decode (codec.py, a copy)
- wire:       the framing, a connection a call (wire.py)
- service:    declarative method specs + server assembly (service.py)
- client:     retrying client stubs + consistent-hash balancing (client.py)
- status:     status codes, RpcError, the in-process call context
"""

from dragonfly2_tpu_torch.rpc.codec import decode, encode, message
from dragonfly2_tpu_torch.rpc.service import MethodKind, ServiceSpec, serve
from dragonfly2_tpu_torch.rpc.client import HashRing, ServiceClient, BalancedClient

__all__ = [
    "message",
    "encode",
    "decode",
    "MethodKind",
    "ServiceSpec",
    "serve",
    "ServiceClient",
    "BalancedClient",
    "HashRing",
]
