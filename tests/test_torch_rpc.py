"""The port's RPC transport (``dragonfly2_tpu_torch/rpc``) against the JAX
package's gRPC one: the codec's bytes, the four method kinds, statuses
and their details, retries, deadlines, the message cap, health, TLS,
balancing, and prompt refusal between the two stacks (they do not
interoperate: each fails fast against the other)."""

from __future__ import annotations

import dataclasses
import socket
import struct
import threading
import time
from typing import Dict, List, Optional

import grpc
import numpy as np
import pytest

from dragonfly2_tpu.rpc import codec as jax_codec
from dragonfly2_tpu.rpc import client as jax_client
from dragonfly2_tpu.rpc import service as jax_service
from dragonfly2_tpu_torch.rpc import codec, wire
from dragonfly2_tpu_torch.rpc.client import (
    BalancedClient,
    ClientTLS,
    HashRing,
    ServiceClient,
)
from dragonfly2_tpu_torch.rpc.health import (
    HEALTH_SPEC,
    NOT_SERVING,
    SERVING,
    HealthCheckRequest,
)
from dragonfly2_tpu_torch.rpc.service import (
    MethodKind,
    ServerTLS,
    ServiceSpec,
    message_limits,
    serve,
)
from dragonfly2_tpu_torch.rpc.status import RpcError, StatusCode

#: A refusal between the two stacks must come within this many seconds.
REFUSAL_S = 5.0


# -- messages, registered alike in both packages --------------------------


def _both(tag: str):
    """Register one dataclass under ``tag`` in each package's codec."""
    def wrap(cls):
        cls = dataclasses.dataclass(cls)
        port_cls = codec.message(tag)(type(cls.__name__, (cls,), {}))
        jax_cls = jax_codec.message(tag)(type(cls.__name__, (cls,), {}))
        return port_cls, jax_cls
    return wrap


@_both("torchrpc.Inner")
class Inner:
    name: str = ""
    payload: bytes = b""
    weights: Optional[np.ndarray] = None
    tags: List[str] = dataclasses.field(default_factory=list)


@_both("torchrpc.Outer")
class Outer:
    idx: int = 0
    ratio: float = 0.0
    flag: bool = False
    inner: Optional[object] = None
    children: List[object] = dataclasses.field(default_factory=list)
    table: Dict[str, int] = dataclasses.field(default_factory=dict)
    members: set = dataclasses.field(default_factory=set)
    raw: bytes = b""


def _rand_outer(rng, pkg: int):
    """A seeded random tree built from package ``pkg``'s classes (0 the
    port's, 1 JAX's); the same seed gives the same values in both."""
    inner_cls, outer_cls = Inner[pkg], Outer[pkg]

    def inner():
        return inner_cls(
            name="".join(chr(rng.integers(32, 0x2FA0))
                         for _ in range(rng.integers(0, 12))),
            payload=rng.bytes(int(rng.integers(0, 512))),
            weights=(rng.standard_normal(
                tuple(rng.integers(0, 5, size=rng.integers(1, 3)))
            ).astype(rng.choice(["float32", "float64", "int32"]))
                if rng.random() < 0.7 else None),
            tags=[f"t{j}" for j in range(rng.integers(0, 4))])

    return outer_cls(
        idx=int(rng.integers(-2**53, 2**53)),
        ratio=float(rng.standard_normal()),
        flag=bool(rng.random() < 0.5),
        inner=inner() if rng.random() < 0.8 else None,
        children=[inner() for _ in range(rng.integers(0, 4))],
        table={f"k{j}": int(rng.integers(0, 1000))
               for j in range(rng.integers(0, 5))},
        members={f"m{j}" for j in range(rng.integers(0, 3))},
        raw=rng.bytes(int(rng.integers(0, 2048))))


def _fields(msg):
    """A message tree as plain values, for equality across packages."""
    if dataclasses.is_dataclass(msg):
        return (msg.__class__.__name__,
                {f.name: _fields(getattr(msg, f.name))
                 for f in dataclasses.fields(msg)})
    if isinstance(msg, np.ndarray):
        return ("ndarray", msg.dtype.str, msg.shape, msg.tobytes())
    if isinstance(msg, list):
        return [_fields(v) for v in msg]
    if isinstance(msg, dict):
        return {k: _fields(v) for k, v in msg.items()}
    return msg


@pytest.mark.parametrize("seed", range(12))
def test_codec_bytes_equal_jax_on_random_trees(seed):
    port_msg = _rand_outer(np.random.default_rng(seed), 0)
    jax_msg = _rand_outer(np.random.default_rng(seed), 1)
    wire_bytes = codec.encode(port_msg)
    assert wire_bytes == jax_codec.encode(jax_msg)
    assert _fields(jax_codec.decode(wire_bytes)) == _fields(jax_msg)
    assert _fields(codec.decode(jax_codec.encode(jax_msg))) == \
        _fields(port_msg)


def _spec_messages():
    """(tag, port instance, JAX instance) for every message of the
    inference, trainer and health specs, with values in every field."""
    from dragonfly2_tpu.inference import sidecar as jax_sidecar
    from dragonfly2_tpu.rpc import health as jax_health
    from dragonfly2_tpu.trainer import service as jax_trainer
    from dragonfly2_tpu_torch.inference import sidecar
    from dragonfly2_tpu_torch.rpc import health
    from dragonfly2_tpu_torch.trainer import service as trainer

    feats = np.random.default_rng(3).standard_normal((4, 7)).astype(
        np.float32)

    def build(side, hl, tr):
        return {
            "inference.ModelInferRequest": side.ModelInferRequest(
                "mlp", feats),
            "inference.ModelInferResponse": side.ModelInferResponse(
                "gat", "v7", feats[:, 0].copy()),
            "inference.ModelReadyRequest": side.ModelReadyRequest("mlp"),
            "inference.ModelReadyResponse": side.ModelReadyResponse(
                True, "v2"),
            "inference.ServerLiveRequest": side.ServerLiveRequest(),
            "inference.ServerLiveResponse": side.ServerLiveResponse(False),
            "inference.ServerReadyRequest": side.ServerReadyRequest(),
            "inference.ServerReadyResponse": side.ServerReadyResponse(True),
            "health.CheckRequest": hl.HealthCheckRequest("svc"),
            "health.CheckReply": hl.HealthCheckReply(hl.NOT_SERVING),
            "trainer.TrainGnnRequest": tr.TrainGnnRequest(b"a,b\n", True),
            "trainer.TrainMlpRequest": tr.TrainMlpRequest(b"c\n", False),
            "trainer.TrainCostRequest": tr.TrainCostRequest(b"d\n", True),
            "trainer.TrainRequest": tr.TrainRequest(
                "host-1", "10.0.0.1", "h1", 42,
                tr.TrainGnnRequest(b"x", True), None,
                tr.TrainCostRequest(b"y", False)),
            "trainer.TrainResponse": tr.TrainResponse("host-1", 123),
        }

    port = build(sidecar, health, trainer)
    ref = build(jax_sidecar, jax_health, jax_trainer)
    return [(tag, port[tag], ref[tag]) for tag in sorted(port)]


SPEC_TAGS = [
    "health.CheckReply", "health.CheckRequest",
    "inference.ModelInferRequest", "inference.ModelInferResponse",
    "inference.ModelReadyRequest", "inference.ModelReadyResponse",
    "inference.ServerLiveRequest", "inference.ServerLiveResponse",
    "inference.ServerReadyRequest", "inference.ServerReadyResponse",
    "trainer.TrainCostRequest", "trainer.TrainGnnRequest",
    "trainer.TrainMlpRequest", "trainer.TrainRequest",
    "trainer.TrainResponse",
]


@pytest.mark.parametrize("tag", SPEC_TAGS)
def test_spec_message_bytes_equal_jax(tag):
    (_, port_msg, jax_msg), = [m for m in _spec_messages() if m[0] == tag]
    data = codec.encode(port_msg)
    assert data == jax_codec.encode(jax_msg)
    assert _fields(jax_codec.decode(data)) == _fields(jax_msg)
    back = codec.decode(data)
    assert type(back) is type(port_msg)
    assert _fields(back) == _fields(port_msg)


def _corruptions():
    wire_bytes = codec.encode(_rand_outer(np.random.default_rng(1), 0))
    hlen = struct.unpack("<I", wire_bytes[4:8])[0]
    return {
        "empty": b"",
        "short": wire_bytes[:6],
        "bad_magic": b"NOPE" + wire_bytes[4:],
        "header_len_lies": (wire_bytes[:4] + struct.pack("<I", 2**31)
                            + wire_bytes[8:]),
        "truncated_header": wire_bytes[:8 + hlen // 2],
        "truncated_blob": wire_bytes[:-50],
    }


@pytest.mark.parametrize("case", sorted(_corruptions()))
def test_corrupt_bytes_raise_value_error_in_both(case):
    data = _corruptions()[case]
    for decode in (codec.decode, jax_codec.decode):
        with pytest.raises(ValueError):
            decode(data)


# -- the four method kinds, statuses, retries ----------------------------


@_both("torchrpc.EchoRequest")
class EchoRequest:
    text: str = ""
    n: int = 1


@_both("torchrpc.EchoReply")
class EchoReply:
    text: str = ""


ECHO_METHODS = {
    "Say": MethodKind.UNARY_UNARY,
    "Stream": MethodKind.UNARY_STREAM,
    "Collect": MethodKind.STREAM_UNARY,
    "Chat": MethodKind.STREAM_STREAM,
    "Boom": MethodKind.UNARY_UNARY,
    "Deny": MethodKind.UNARY_UNARY,
    "Slow": MethodKind.UNARY_UNARY,
    "Big": MethodKind.UNARY_UNARY,
}
ECHO_SPEC = ServiceSpec(name="df2.torchtest.Echo", methods=ECHO_METHODS)
JAX_ECHO_SPEC = jax_service.ServiceSpec(
    name="df2.torchtest.Echo",
    methods={m: jax_service.MethodKind(k.value)
             for m, k in ECHO_METHODS.items()})


class EchoService:
    """One implementation for both packages: ``pkg`` picks the reply
    class and the abort code's enum."""

    def __init__(self, pkg: int):
        self.pkg = pkg
        self.slow_done = threading.Event()

    def _reply(self, text: str):
        return EchoReply[self.pkg](text=text)

    def Say(self, request, context):  # noqa: N802
        return self._reply(request.text)

    def Stream(self, request, context):  # noqa: N802
        for i in range(request.n):
            yield self._reply(f"{request.text}:{i}")

    def Collect(self, request_iterator, context):  # noqa: N802
        return self._reply("".join(r.text for r in request_iterator))

    def Chat(self, request_iterator, context):  # noqa: N802
        for r in request_iterator:
            yield self._reply(r.text.upper())

    def Boom(self, request, context):  # noqa: N802
        raise RuntimeError("kaboom")

    def Deny(self, request, context):  # noqa: N802
        code = (StatusCode.NOT_FOUND if self.pkg == 0
                else grpc.StatusCode.NOT_FOUND)
        context.abort(code, f"no {request.text!r} here")

    def Slow(self, request, context):  # noqa: N802
        time.sleep(request.n / 10)
        self.slow_done.set()
        return self._reply(request.text)

    def Big(self, request, context):  # noqa: N802
        return self._reply("x" * request.n)


@pytest.fixture(scope="module")
def servers():
    """The echo service served by each stack: (port server, its service,
    JAX server)."""
    port_impl = EchoService(0)
    port = serve([(ECHO_SPEC, port_impl)])
    ref = jax_service.serve([(JAX_ECHO_SPEC, EchoService(1))])
    yield port, port_impl, ref
    port.stop()
    ref.stop()


@pytest.fixture()
def cli(servers):
    client = ServiceClient(servers[0].target, ECHO_SPEC)
    yield client
    client.close()


def _jax_cli(servers):
    return jax_client.ServiceClient(servers[2].target, JAX_ECHO_SPEC)


def test_unary_unary(cli):
    assert cli.Say(EchoRequest[0](text="hi")).text == "hi"


def test_unary_stream(cli):
    out = [r.text for r in cli.Stream(EchoRequest[0](text="p", n=3))]
    assert out == ["p:0", "p:1", "p:2"]


def test_stream_unary(cli):
    reply = cli.Collect(iter([EchoRequest[0](text="a"),
                              EchoRequest[0](text="b")]))
    assert reply.text == "ab"


def test_stream_stream(cli):
    out = [r.text for r in cli.Chat(iter([EchoRequest[0](text="x"),
                                          EchoRequest[0](text="y")]))]
    assert out == ["X", "Y"]


def test_stream_stream_is_full_duplex(cli):
    """A reply arrives before the request stream ends, as a bidi
    stream's caller (the probe sync's started → candidates → finished)
    needs."""
    import queue

    send: "queue.Queue" = queue.Queue()

    def requests():
        while (item := send.get()) is not None:
            yield EchoRequest[0](text=item)

    replies = cli.Chat(requests(), timeout=10)
    send.put("first")
    assert next(replies).text == "FIRST"
    send.put("second")
    assert next(replies).text == "SECOND"
    send.put(None)
    assert list(replies) == []


@pytest.mark.parametrize("method", ["Boom", "Deny", "Missing"])
def test_status_and_details_equal_jax(servers, method):
    """An uncaught exception is INTERNAL "<Type>: <message>", an abort
    keeps its code and details, an unknown method is UNIMPLEMENTED."""
    spec = ECHO_SPEC
    jax_spec = JAX_ECHO_SPEC
    if method == "Missing":  # a client that knows a method the server lacks
        spec = ServiceSpec(ECHO_SPEC.name, {"Missing": MethodKind.UNARY_UNARY})
        jax_spec = jax_service.ServiceSpec(
            ECHO_SPEC.name, {"Missing": jax_service.MethodKind.UNARY_UNARY})
    port_cli = ServiceClient(servers[0].target, spec, retries=0)
    jax_cli = jax_client.ServiceClient(servers[2].target, jax_spec,
                                       retries=0)
    with pytest.raises(RpcError) as port_err:
        getattr(port_cli, method)(EchoRequest[0](text="x"), timeout=5)
    with pytest.raises(grpc.RpcError) as jax_err:
        getattr(jax_cli, method)(EchoRequest[1](text="x"), timeout=5)
    jax_cli.close()
    assert port_err.value.code().name == jax_err.value.code().name
    assert port_err.value.details() == jax_err.value.details()
    assert port_err.value.code() is {
        "Boom": StatusCode.INTERNAL, "Deny": StatusCode.NOT_FOUND,
        "Missing": StatusCode.UNIMPLEMENTED}[method]


class CountingListener:
    """Accepts and at once closes every connection, counting them: each
    call on it fails UNAVAILABLE."""

    def __init__(self):
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.target = f"127.0.0.1:{self.sock.getsockname()[1]}"
        self.accepts = 0
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.accepts += 1
            conn.close()

    def close(self):
        self.sock.shutdown(socket.SHUT_RDWR)
        self.sock.close()
        self.thread.join(timeout=5)


@pytest.mark.parametrize("method,attempts", [
    ("Say", 4), ("Stream", 4), ("Collect", 1), ("Chat", 1)])
def test_unavailable_retried_on_unary_kinds_only(method, attempts):
    listener = CountingListener()
    cli = ServiceClient(listener.target, ECHO_SPEC, retries=3,
                        backoff=0.01)
    request = EchoRequest[0](text="x")
    if ECHO_METHODS[method] in (MethodKind.STREAM_UNARY,
                                MethodKind.STREAM_STREAM):
        request = iter([request])
    try:
        with pytest.raises(RpcError) as err:
            out = getattr(cli, method)(request, timeout=5)
            if method == "Chat":
                list(out)
        assert err.value.code() is StatusCode.UNAVAILABLE
        assert listener.accepts == attempts
    finally:
        listener.close()


def test_refused_connection_is_unavailable_after_retries():
    dead = socket.create_server(("127.0.0.1", 0))
    target = f"127.0.0.1:{dead.getsockname()[1]}"
    dead.close()
    t0 = time.monotonic()
    with pytest.raises(RpcError) as err:
        ServiceClient(target, ECHO_SPEC, backoff=0.01).Say(
            EchoRequest[0](text="x"), timeout=5)
    assert err.value.code() is StatusCode.UNAVAILABLE
    assert time.monotonic() - t0 < REFUSAL_S


def test_deadline_exceeded_at_the_client_and_the_worker_survives(servers,
                                                                 cli):
    impl = servers[1]
    impl.slow_done.clear()
    t0 = time.monotonic()
    with pytest.raises(RpcError) as err:
        cli.Slow(EchoRequest[0](text="late", n=30), timeout=0.1)
    assert err.value.code() is StatusCode.DEADLINE_EXCEEDED
    # Raised at the client's deadline, long before the server's 3 s.
    assert time.monotonic() - t0 < 1.5
    # The server finishes the call and writes to a closed connection.
    assert impl.slow_done.wait(10)
    time.sleep(0.05)
    assert cli.Say(EchoRequest[0](text="after")).text == "after"


def test_message_cap_defaults_to_256_mib():
    assert message_limits(None) == (256 << 20, 256 << 20)
    assert wire.MAX_MESSAGE_BYTES == 256 * 1024 * 1024


@pytest.mark.parametrize("side", ["client_send", "server_receive",
                                  "server_send", "client_receive"])
def test_message_over_the_cap_is_resource_exhausted(side):
    cap = 1 << 16
    small = [("grpc.max_send_message_length", cap),
             ("grpc.max_receive_message_length", cap)]
    server = serve([(ECHO_SPEC, EchoService(0))],
                   options=small if side.startswith("server") else None)
    cli = ServiceClient(server.target, ECHO_SPEC, retries=0,
                        options=small if side.startswith("client") else None)
    try:
        with pytest.raises(RpcError) as err:
            if side in ("client_send", "server_receive"):
                cli.Say(EchoRequest[0](text="x" * (2 * cap)), timeout=10)
            else:
                cli.Big(EchoRequest[0](n=2 * cap), timeout=10)
        assert err.value.code() is StatusCode.RESOURCE_EXHAUSTED
        assert "larger than max" in err.value.details()
        assert cli.Say(EchoRequest[0](text="ok"), timeout=10).text == "ok"
    finally:
        server.stop()


@pytest.mark.parametrize("error", [RuntimeError, FileNotFoundError])
def test_client_iterator_failure_cancels_the_stream(servers, cli, error):
    """A request iterator that raises fails the call at once (UNKNOWN,
    as grpc) and the server sees the stream end uncleanly — an
    ``OSError`` of the iterator's own (a file it reads is missing) too,
    which is not the socket's."""
    def dying():
        yield EchoRequest[0](text="a")
        raise error("connection dropped")

    begin = time.monotonic()
    with pytest.raises(RpcError) as err:
        cli.Collect(dying(), timeout=5)
    assert time.monotonic() - begin < 2.0
    assert err.value.code() is StatusCode.UNKNOWN
    assert err.value.details() == "Exception iterating requests!"
    assert cli.Say(EchoRequest[0](text="still")).text == "still"


def test_closed_client_refuses_calls(servers):
    cli = ServiceClient(servers[0].target, ECHO_SPEC)
    cli.close()
    with pytest.raises(ValueError):
        cli.Say(EchoRequest[0](text="x"))


def test_parallel_unary_calls(servers):
    cli = ServiceClient(servers[0].target, ECHO_SPEC)
    errors: list = []

    def worker(i):
        try:
            for j in range(20):
                text = f"{i}-{j}"
                assert cli.Say(EchoRequest[0](text=text),
                               timeout=10).text == text
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


# -- health -------------------------------------------------------------------


def test_health_mounted_and_stop_drains_through_not_serving():
    server = serve([(ECHO_SPEC, EchoService(0))])
    cli = ServiceClient(server.target, HEALTH_SPEC, retries=0)
    assert cli.Check(HealthCheckRequest(service=""), timeout=5).status \
        == SERVING
    assert cli.Check(HealthCheckRequest(service=ECHO_SPEC.name),
                     timeout=5).status == SERVING
    ServiceClient(server.target, ECHO_SPEC).wait_ready(timeout=5)
    server.stop()
    assert server.health.Check(HealthCheckRequest(service="")).status \
        == NOT_SERVING
    with pytest.raises(RpcError) as err:
        cli.Check(HealthCheckRequest(service=""), timeout=5)
    assert err.value.code() is StatusCode.UNAVAILABLE


def test_drain_window_answers_not_serving_before_the_listener_dies():
    server = serve([(ECHO_SPEC, EchoService(0))])
    cli = ServiceClient(server.target, HEALTH_SPEC, retries=0)
    stopper = threading.Thread(target=server.stop,
                               kwargs={"drain_s": 0.5})
    stopper.start()
    time.sleep(0.1)
    assert cli.Check(HealthCheckRequest(service=""), timeout=5).status \
        == NOT_SERVING
    stopper.join(timeout=10)
    assert not stopper.is_alive()


# -- balancing ----------------------------------------------------------------


def test_hash_ring_owners_equal_jax():
    targets = ["s1:80", "s2:80", "s3:80", "10.0.0.4:65002"]
    port, ref = HashRing(targets), jax_client.HashRing(targets)
    keys = [f"task-{i}" for i in range(2000)]
    assert [port.pick(k) for k in keys] == [ref.pick(k) for k in keys]
    assert list(port.walk("task-7")) == list(ref.walk("task-7"))
    port.remove("s2:80")
    ref.remove("s2:80")
    assert [port.pick(k) for k in keys] == [ref.pick(k) for k in keys]


def test_balanced_client_fails_over(servers):
    bal = BalancedClient(ECHO_SPEC, [servers[0].target, "127.0.0.1:1"],
                         retries=0)
    for i in range(20):
        assert bal.call(f"task-{i}", "Say", EchoRequest[0](text=str(i)),
                        timeout=5).text == str(i)
    with pytest.raises(ValueError):
        bal.call("k", "Collect", iter([]))
    bal.update_targets([servers[0].target])
    assert bal.ring.targets == {servers[0].target}
    bal.close()


# -- TLS ----------------------------------------------------------------------

TLS_SPEC = ServiceSpec("df2.torchtest.Secure",
                       {"Ping": MethodKind.UNARY_UNARY})


class SecureImpl:
    def Ping(self, request, context):  # noqa: N802
        return EchoReply[0](text="pong")


@pytest.fixture(scope="module")
def ca(tmp_path_factory):
    pytest.importorskip("cryptography")
    from dragonfly2_tpu_torch.utils.certs import CertAuthority

    return CertAuthority(str(tmp_path_factory.mktemp("ca")))


def _tls_case(ca, tmp_path, case: str) -> None:
    from dragonfly2_tpu_torch.utils.certs import CertAuthority

    cert, key = ca.cert_for("localhost")
    mutual = case in ("mtls", "mtls_without_client_cert")
    server = serve([(TLS_SPEC, SecureImpl())], tls=ServerTLS(
        cert_path=cert, key_path=key,
        client_ca_path=ca.ca_cert_path if mutual else ""))
    if case == "insecure_client":
        tls = None
    elif case == "untrusted_ca":
        other = CertAuthority(str(tmp_path / "other-ca"))
        tls = ClientTLS(ca_path=other.ca_cert_path,
                        server_name_override="localhost")
    elif case == "mtls":
        ccert, ckey = ca.client_cert_for("daemon-1")
        tls = ClientTLS(ca_path=ca.ca_cert_path, cert_path=ccert,
                        key_path=ckey, server_name_override="localhost")
    else:
        tls = ClientTLS(ca_path=ca.ca_cert_path,
                        server_name_override="localhost")
    cli = ServiceClient(server.target, TLS_SPEC, retries=0, tls=tls)
    try:
        if case in ("tls", "mtls"):
            assert cli.Ping(EchoRequest[0](), timeout=10).text == "pong"
        else:
            t0 = time.monotonic()
            with pytest.raises(RpcError) as err:
                cli.Ping(EchoRequest[0](), timeout=5)
            assert err.value.code() is StatusCode.UNAVAILABLE
            assert time.monotonic() - t0 < REFUSAL_S
    finally:
        server.stop()


@pytest.mark.parametrize("case", ["tls", "mtls", "mtls_without_client_cert",
                                  "untrusted_ca", "insecure_client"])
def test_tls(ca, tmp_path, case):
    _tls_case(ca, tmp_path, case)


# -- the two stacks refuse each other promptly --------------------------------


def test_grpc_client_against_the_wire_fails_promptly(servers):
    jax_cli = jax_client.ServiceClient(servers[0].target, JAX_ECHO_SPEC,
                                       retries=0)
    t0 = time.monotonic()
    with pytest.raises(grpc.RpcError):
        jax_cli.Say(EchoRequest[1](text="x"), timeout=REFUSAL_S)
    assert time.monotonic() - t0 < REFUSAL_S + 0.5
    jax_cli.close()
    # The wire server goes on serving its own clients.
    cli = ServiceClient(servers[0].target, ECHO_SPEC)
    assert cli.Say(EchoRequest[0](text="ok"), timeout=5).text == "ok"


def test_wire_client_against_grpc_fails_promptly(servers):
    cli = ServiceClient(servers[2].target, ECHO_SPEC, retries=0)
    t0 = time.monotonic()
    with pytest.raises(RpcError) as err:
        cli.Say(EchoRequest[0](text="x"))  # no deadline: must not hang
    assert err.value.code() is StatusCode.UNAVAILABLE
    assert time.monotonic() - t0 < REFUSAL_S
    jax_cli = _jax_cli(servers)
    assert jax_cli.Say(EchoRequest[1](text="ok"), timeout=5).text == "ok"
    jax_cli.close()
