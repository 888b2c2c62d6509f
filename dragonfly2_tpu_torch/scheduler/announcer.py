"""Scheduler announcer: manager keepalive + dataset upload to the trainer.

Reference counterpart: scheduler/announcer/announcer.go:72-235. Two loops:
- announce_to_manager: UpdateScheduler on start, then keepalive ticks;
- announce_to_trainer: every ``interval`` stream both CSV datasets to the
  trainer in chunks (reference buffer: 128 MiB; ours is configurable and
  marks rotated-file boundaries so per-file CSV headers survive).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Iterator, Optional, Protocol

from dragonfly2_tpu_torch.scheduler.storage import Storage
from dragonfly2_tpu_torch.trainer.service import (
    TrainCostRequest,
    TrainGnnRequest,
    TrainMlpRequest,
    TrainRequest,
)

logger = logging.getLogger(__name__)

DEFAULT_UPLOAD_CHUNK = 128 * 1024 * 1024  # announcer.go:38-41


class ManagerAnnounceClient(Protocol):
    def update_scheduler(self, host_id: str, ip: str, hostname: str, port: int) -> None: ...
    def keepalive(self, host_id: str) -> None: ...


class TrainerTrainClient(Protocol):
    def train(self, requests: Iterator[TrainRequest]): ...


@dataclass
class AnnouncerConfig:
    trainer_interval: float = 600.0
    keepalive_interval: float = 5.0
    upload_chunk: int = DEFAULT_UPLOAD_CHUNK


class Announcer:
    def __init__(
        self,
        host_id: str,
        ip: str,
        hostname: str,
        port: int,
        storage: Storage,
        trainer_client: Optional[TrainerTrainClient] = None,
        manager_client: Optional[ManagerAnnounceClient] = None,
        config: Optional[AnnouncerConfig] = None,
        scheduler_id: int = 0,
    ) -> None:
        self.host_id = host_id
        self.ip = ip
        self.hostname = hostname
        self.port = port
        # Manager-assigned instance id; keys trainer model uploads so
        # multi-cluster deployments don't evict each other's models.
        self.scheduler_id = scheduler_id
        self.storage = storage
        self.trainer_client = trainer_client
        self.manager_client = manager_client
        self.config = config or AnnouncerConfig()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- lifecycle ------------------------------------------------------------

    def serve(self) -> None:
        if self.manager_client is not None:
            self.manager_client.update_scheduler(
                self.host_id, self.ip, self.hostname, self.port
            )
            self._spawn(self._keepalive_loop, "announcer-keepalive")
        if self.trainer_client is not None:
            self._spawn(self._trainer_loop, "announcer-trainer")

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)

    def _spawn(self, fn, name: str) -> None:
        t = threading.Thread(target=fn, name=name, daemon=True)
        t.start()
        self._threads.append(t)

    def _keepalive_loop(self) -> None:
        while not self._stop.wait(self.config.keepalive_interval):
            try:
                self.manager_client.keepalive(self.host_id)
            except Exception:  # noqa: BLE001 — keepalive must not die
                logger.exception("manager keepalive failed")

    def _trainer_loop(self) -> None:
        while not self._stop.wait(self.config.trainer_interval):
            try:
                self.train()
            except Exception:  # noqa: BLE001
                logger.exception("dataset upload to trainer failed")

    # -- upload ---------------------------------------------------------------

    def train(self) -> Optional[object]:
        """announcer.go:142-169 — one upload cycle, both datasets.

        Takes a frozen snapshot (active files force-rotated), streams it,
        and deletes exactly the snapshotted files after the trainer accepts
        — records arriving during the (possibly minutes-long) upload land
        in fresh active files and ship next tick; a failed upload keeps the
        snapshot on disk and retries with full data next tick.
        """
        if self.trainer_client is None:
            return None
        download_files = self.storage.snapshot_download()
        topology_files = self.storage.snapshot_network_topology()
        replay_files = self.storage.snapshot_replay()
        if not download_files and not topology_files and not replay_files:
            logger.info("no datasets to upload")
            return None

        response = self.trainer_client.train(
            self._requests(download_files, topology_files, replay_files)
        )
        self.storage.remove_download_files(download_files)
        self.storage.remove_network_topology_files(topology_files)
        self.storage.remove_replay_files(replay_files)
        return response

    def _requests(self, download_files, topology_files,
                  replay_files=()) -> Iterator[TrainRequest]:
        base = dict(host_id=self.host_id, ip=self.ip, hostname=self.hostname,
                    scheduler_id=self.scheduler_id)
        for path in topology_files:
            for i, chunk in enumerate(self._chunks(path)):
                yield TrainRequest(
                    **base, gnn=TrainGnnRequest(dataset=chunk, new_file=i == 0)
                )
        for path in download_files:
            for i, chunk in enumerate(self._chunks(path)):
                yield TrainRequest(
                    **base, mlp=TrainMlpRequest(dataset=chunk, new_file=i == 0)
                )
        for path in replay_files:
            for i, chunk in enumerate(self._chunks(path)):
                yield TrainRequest(
                    **base,
                    cost=TrainCostRequest(dataset=chunk, new_file=i == 0)
                )

    def _chunks(self, path: str) -> Iterator[bytes]:
        size = self.config.upload_chunk
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            while True:
                chunk = f.read(size)
                if not chunk:
                    break
                yield chunk
