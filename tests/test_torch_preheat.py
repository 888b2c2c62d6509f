"""The port's preheat held to JAX's ``tests/test_preheat.py``, each body
on both packages: manifest resolution (single and multi-arch), the
in-process ``JobBus``'s group tracking, a preheat through the full chain
after which a peer downloads with the origin closed, the REST pipeline
(``POST /api/v1/jobs``) after which a child completes the task with no
origin request, and a preheat without a seed failing its group."""

from __future__ import annotations

import hashlib
import importlib
import os
import time

import pytest

from tests.fileserver import FileServer
from tests.test_preheat import write_registry
from tests.test_torch_p2p import PACKAGES as MESHES

PKGS = {"jax": "dragonfly2_tpu", "port": "dragonfly2_tpu_torch"}


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return request.param


class Mesh:
    """A scheduler of ``pkg`` with a seed daemon (optional) and a job
    bus whose ``SchedulerJobWorker`` serves ``scheduler_id``."""

    def __init__(self, pkg: str, root, scheduler_id: int, seed: bool = True):
        make_scheduler, self._make_daemon = MESHES[pkg]
        self.root = root
        self.scheduler = make_scheduler(root)
        self.daemons = []
        if seed:
            seeder = self.daemon("seed", seed=True)
            self.scheduler.seed_peer_client = seeder.seed_client()
        self.jobs = mod(pkg, "manager.jobs")
        self.bus = self.jobs.JobBus()
        self.jobs.SchedulerJobWorker(self.bus, self.scheduler,
                                     scheduler_id=scheduler_id).serve()

    def daemon(self, name: str, seed: bool = False):
        daemon = self._make_daemon(self.scheduler, self.root, name, seed)
        self.daemons.append(daemon)
        return daemon

    def close(self) -> None:
        self.bus.stop()
        for daemon in reversed(self.daemons):
            daemon.stop()


def test_image_ref_parse(pkg):
    ref = mod(pkg, "manager.jobs").ImageRef.parse(
        "http://reg:5000/v2/library/nginx/manifests/1.25")
    assert (ref.registry, ref.name, ref.tag) == (
        "http://reg:5000", "library/nginx", "1.25")
    assert ref.blob_url("sha256:abc").endswith(
        "/v2/library/nginx/blobs/sha256:abc")
    with pytest.raises(ValueError):
        mod(pkg, "manager.jobs").ImageRef.parse("http://reg/just/a/file.txt")


@pytest.mark.parametrize("multi_arch", [False, True])
def test_resolve_layers(pkg, multi_arch, tmp_path):
    layers = {f"sha256:{i:064x}": os.urandom(100) for i in range(3)}
    name = write_registry(tmp_path, layers, multi_arch=multi_arch)
    with FileServer(str(tmp_path)) as fs:
        urls = mod(pkg, "manager.jobs").resolve_image_layers(
            f"http://127.0.0.1:{fs.port}/v2/{name}/manifests/latest")
    assert [u.rsplit("/", 1)[1] for u in urls] == list(layers)
    assert all("/blobs/sha256:" in u for u in urls)


def test_job_bus_group_tracking(pkg):
    jobs = mod(pkg, "manager.jobs")
    bus = jobs.JobBus()
    seen = []
    bus.serve_worker("q1", lambda job: seen.append(job.id))

    def boom(job):
        raise RuntimeError("nope")

    bus.serve_worker("q2", boom)
    status = bus.post_group(["q1", "q2"], lambda: jobs.Job(
        id="j", type="preheat", payload=jobs.PreheatRequest(url="u")))
    deadline = time.monotonic() + 5
    while not status.done and time.monotonic() < deadline:
        time.sleep(0.01)
    try:
        assert status.done and seen == ["j"]
        assert status.succeeded == 1 and status.failed == 1
        assert status.state == "FAILURE"
        assert "nope" in status.errors[0]
    finally:
        bus.stop()


def test_preheat_then_peer_downloads_without_origin(pkg, tmp_path):
    layers = {"sha256:" + "a" * 64: os.urandom(2 * 1024 * 1024)}
    name = write_registry(tmp_path, layers)
    mesh = Mesh(pkg, tmp_path, scheduler_id=7)
    preheat = mesh.jobs.PreheatService(mesh.bus)
    peer = mesh.daemon("peer")
    try:
        with FileServer(str(tmp_path)) as fs:
            image = f"http://127.0.0.1:{fs.port}/v2/{name}/manifests/latest"
            groups = preheat.preheat_image(image, scheduler_ids=[7])
            assert preheat.wait(groups, timeout=60), [
                (g.state, g.errors) for g in groups]
            blob_url = mesh.jobs.resolve_image_layers(image)[0]
        result = peer.download_file(blob_url)  # the origin is closed
        assert result.success, result.error
        assert hashlib.sha256(result.read_all()).digest() == \
            hashlib.sha256(layers["sha256:" + "a" * 64]).digest()
    finally:
        mesh.close()


def test_rest_job_preheat_pipeline_zero_origin(pkg, tmp_path):
    manager = mod(pkg, "manager")
    auth_mod = mod(pkg, "manager.auth")
    blob = os.urandom(2 * 1024 * 1024 + 99)
    (tmp_path / "ckpt.bin").write_bytes(blob)
    mesh = Mesh(pkg, tmp_path, scheduler_id=11)
    service = manager.ManagerService(
        manager.Database(":memory:"),
        manager.FilesystemObjectStore(str(tmp_path / "objects")))
    api = mod(pkg, "manager.rest").RestApi(
        service, auth=auth_mod.AuthService(service.db, secret="s"),
        preheat=mesh.jobs.PreheatService(mesh.bus))
    code, payload = api.dispatch(
        "POST", "/api/v1/users/signin", {},
        {"name": auth_mod.DEFAULT_ROOT_USER,
         "password": auth_mod.DEFAULT_ROOT_PASSWORD})
    assert code == 200, payload
    token = "Bearer " + payload["token"]
    child = mesh.daemon("rest-child")
    try:
        with FileServer(str(tmp_path)) as fs:
            url = fs.url("ckpt.bin")
            code, payload = api.dispatch(
                "POST", "/api/v1/jobs", {},
                {"type": "preheat", "args": {"url": url},
                 "scheduler_ids": [11]}, authorization=token)
            assert code == 200, payload
            job_id = payload["ids"][0]
            deadline, state = time.monotonic() + 60, "PENDING"
            while state == "PENDING" and time.monotonic() < deadline:
                code, status = api.dispatch(
                    "GET", f"/api/v1/jobs/{job_id}", {}, {},
                    authorization=token)
                assert code == 200, status
                state = status["state"]
                time.sleep(0.05)
            assert state == "SUCCESS", status
            fs.reset_counters()
            result = child.download_file(url)
            assert result.success, result.error
            assert hashlib.md5(result.read_all()).digest() == \
                hashlib.md5(blob).digest()
            assert fs.request_count == 0
    finally:
        mesh.close()


def test_preheat_without_seed_fails_group(pkg, tmp_path):
    mesh = Mesh(pkg, tmp_path, scheduler_id=1, seed=False)
    try:
        preheat = mesh.jobs.PreheatService(mesh.bus)
        # A loopback URL: the group must fail before any fetch.
        groups = preheat.preheat_urls(["http://127.0.0.1:9/blob"],
                                      scheduler_ids=[1])
        assert not preheat.wait(groups, timeout=10)
        assert groups[0].state == "FAILURE"
        assert "seed" in groups[0].errors[0]
    finally:
        mesh.close()
