"""The trainer service over the wire: the scheduler's announcer streaming
its datasets to the port's ``TrainerService`` served through
``rpc.serve`` (``cmd.scheduler.TrainerClient``), against the JAX
package's over gRPC — equal ``TrainResponse``s, equal segments (bytes),
equal statuses and details for bad streams, and equal rollback when a
client hangs up mid-stream.

The records and announcer settings are ``tests/test_torch_trainer_service.py``'s
(``fill_storage``: 24 hosts, every dataset rotating); training is a stub,
so only the transport and the ingest run.
"""

from __future__ import annotations

import os
import socket
import threading
import time

import grpc
import pytest

from dragonfly2_tpu.rpc import client as jax_client
from dragonfly2_tpu.rpc import service as jax_service
from dragonfly2_tpu_torch.cmd.scheduler import TrainerClient
from dragonfly2_tpu_torch.rpc import serve, wire
from dragonfly2_tpu_torch.rpc.codec import encode
from dragonfly2_tpu_torch.rpc.status import RpcError
from dragonfly2_tpu_torch.trainer import TrainerStorage
from tests.test_torch_trainer_service import (
    HOST_ID,
    PACKAGES,
    PKGS,
    StubTraining,
    announcer_for,
    fill_storage,
    mlp_request,
)


class JaxTrainerClient:
    """JAX's ``cmd/scheduler.py`` trainer client (its body, over grpc)."""

    def __init__(self, target):
        from dragonfly2_tpu.trainer import TRAINER_SPEC

        self.cli = jax_client.ServiceClient(target, TRAINER_SPEC)

    def train(self, requests):
        return self.cli.Train(requests, timeout=3600)


def served(pkg_name: str, root, storage_cls=None):
    """(server, service, storage, training stub, client) of one package,
    the service over its own transport."""
    pkg = PACKAGES[pkg_name]
    storage = (storage_cls or pkg.trainer.TrainerStorage)(str(root))
    training = StubTraining()
    service = pkg.trainer.TrainerService(storage, training,
                                         train_async=False)
    # Set once the server's Train has returned or raised: a client's
    # call can fail before the server has read its stream.
    service.train_done = threading.Event()
    train = service.Train

    def traced_train(request_iterator, context):
        try:
            return train(request_iterator, context)
        finally:
            service.train_done.set()

    service.Train = traced_train
    if pkg_name == "port":
        server = serve([(pkg.trainer.TRAINER_SPEC, service)])
        client = TrainerClient(server.target)
    else:
        server = jax_service.serve([(pkg.trainer.TRAINER_SPEC, service)])
        client = JaxTrainerClient(server.target)
    return server, service, storage, training, client


def segment_bytes(storage, host_id: str) -> dict:
    """Every segment of a host by dataset, as (file name, bytes)."""
    out = {}
    for kind, files in (("download", storage.download_files(host_id)),
                        ("topology", storage.network_topology_files(host_id)),
                        ("replay", storage.replay_files(host_id))):
        out[kind] = []
        for path in files:
            with open(path, "rb") as f:
                out[kind].append((os.path.basename(path), f.read()))
    return out


@pytest.fixture(scope="module")
def uploads(tmp_path_factory):
    """Each package's announcer → its trainer client → its transport →
    its service, on the same records."""
    out = {}
    for name in PKGS:
        root = tmp_path_factory.mktemp(f"upload-{name}")
        server, _, storage, training, client = served(name, root / "trainer")
        announcer = announcer_for(PACKAGES[name],
                                  fill_storage(PACKAGES[name],
                                               root / "scheduler"),
                                  client, upload_chunk=8192)
        try:
            response = announcer.train()
            out[name] = {"response": (response.host_id,
                                      response.accepted_bytes),
                         "segments": segment_bytes(storage, HOST_ID),
                         "trained": list(training.calls)}
        finally:
            server.stop()
    return out


def test_train_responses_equal(uploads):
    assert uploads["port"]["response"] == uploads["jax"]["response"]
    assert uploads["port"]["response"][0] == HOST_ID
    assert uploads["port"]["response"][1] > 0


@pytest.mark.parametrize("kind", ["download", "topology", "replay"])
def test_segments_equal_byte_for_byte(uploads, kind):
    port, ref = (uploads[p]["segments"][kind] for p in ("port", "jax"))
    assert port and port == ref
    # The download dataset rotated: several segments streamed.
    assert len(uploads["port"]["segments"]["download"]) > 1


def test_training_started_alike(uploads):
    assert uploads["port"]["trained"] == uploads["jax"]["trained"]
    assert len(uploads["port"]["trained"]) == 1


@pytest.mark.parametrize("case", ["empty", "no_host_id"])
def test_bad_streams_equal_status_and_details(tmp_path, case):
    outcome = {}
    for name in PKGS:
        pkg = PACKAGES[name]
        server, _, _, _, client = served(name, tmp_path / name)
        requests = [] if case == "empty" else [pkg.trainer.TrainRequest(
            gnn=pkg.trainer.TrainGnnRequest(dataset=b"x"))]
        error = RpcError if name == "port" else grpc.RpcError
        try:
            with pytest.raises(error) as exc:
                client.train(iter(requests))
        finally:
            server.stop()
        outcome[name] = (exc.value.code().name, exc.value.details())
    assert outcome["port"] == outcome["jax"]
    assert outcome["port"][0] == "INVALID_ARGUMENT"


def recording(storage_cls, append_delay_s: float = 0.0):
    """``storage_cls`` that sets ``discarded`` once the service rolls a
    stream back, and whose appends take ``append_delay_s`` (so a
    client's hang-up has landed by the time the stream's end is read)."""
    class Recording(storage_cls):
        def __init__(self, root):
            super().__init__(root)
            self.discarded = threading.Event()

        def append(self, *args, **kwargs):
            time.sleep(append_delay_s)
            return super().append(*args, **kwargs)

        def discard_files(self, paths):
            super().discard_files(paths)
            self.discarded.set()

    return Recording


def _settled(service, storage, timeout_s: float = 10.0) -> list:
    """The host's segments once the server's Train has ended, or after
    ``timeout_s`` when the transport cancelled the call before the
    server ran it (then nothing was written)."""
    service.train_done.wait(timeout_s)
    return storage.download_files("h")


def test_hang_up_mid_stream_rolls_back_as_jax(tmp_path):
    """A client whose request iterator dies after one chunk: the call
    fails at the client and the server discards the partial segment."""
    outcome = {}
    for name in PKGS:
        pkg = PACKAGES[name]
        server, service, storage, training, client = served(
            name, tmp_path / name)

        def dying():
            yield mlp_request(pkg, b"id,chunk\n")
            raise RuntimeError("connection dropped")

        error = RpcError if name == "port" else grpc.RpcError
        try:
            with pytest.raises(error) as exc:
                client.train(dying())
            outcome[name] = (exc.value.code().name,
                             _settled(service, storage), training.calls)
        finally:
            server.stop()
    assert outcome["port"] == outcome["jax"] == ("UNKNOWN", [], [])


def test_clean_end_then_hang_up_rolls_back(tmp_path):
    """The ordering the service's ``is_active`` check exists for: the
    client half-closes after its last chunk (END) and hangs up before
    the reply. The stream ends cleanly; the service still rolls back and
    trains nothing, as JAX's does on grpc's clean-EOF cancellation
    (``test_dead_context_rolls_back_as_jax``)."""
    server, service, storage, training, _ = served(
        "port", tmp_path, recording(TrainerStorage, append_delay_s=0.05))
    pkg = PACKAGES["port"]
    try:
        conn = wire.connect(server.target)
        conn.send(wire.MAGIC + wire.frame(wire.HEAD, wire.encode_head(
            "/df2.trainer.Trainer/Train", [], 30.0)))
        conn.send_message(encode(mlp_request(pkg, b"id,chunk\n")),
                          suffix=wire.frame(wire.END))
        conn.sock.shutdown(socket.SHUT_WR)
        # Read the server's magic first: closing with unread input would
        # reset the connection instead of ending it.
        conn.expect_magic()
        conn.close()
        assert _settled(service, storage) == []
        assert storage.discarded.is_set()  # it wrote, then rolled back
        assert training.calls == []
    finally:
        server.stop()


def test_large_chunks_stream_through(tmp_path):
    """Multi-MiB chunks (an announcer at a large upload chunk) arrive
    whole: the stream's bytes equal the segment's."""
    server, _, storage, _, client = served("port", tmp_path)
    pkg = PACKAGES["port"]
    blob = os.urandom(6 << 20)
    try:
        resp = client.train(iter([
            mlp_request(pkg, blob[:3 << 20]),
            pkg.trainer.TrainRequest(
                host_id="h", mlp=pkg.trainer.TrainMlpRequest(
                    dataset=blob[3 << 20:], new_file=False))]))
        assert resp.accepted_bytes == len(blob)
        (path,) = storage.download_files("h")
        with open(path, "rb") as f:
            assert f.read() == blob
    finally:
        server.stop()
