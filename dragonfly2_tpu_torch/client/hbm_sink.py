"""Device-memory sink — P2P-fetched safetensors land straight on the card.

Port of ``dragonfly2_tpu/client/hbm_sink.py`` (BASELINE config #5: dfget
fans a model's safetensors across the mesh and the bytes end on the
device without a load-from-disk pass). An offset-indexed host staging
buffer absorbs pieces in arrival order, the safetensors header is parsed
as soon as its bytes are covered, and each tensor is copied to the card
as soon as its span completes, so the copies overlap the rest of the
download. On an H100 the device memory is HBM3, as on the TPU.

Where the JAX module calls ``jax.device_put``, this one copies from a
pinned staging buffer with ``Tensor.copy_(..., non_blocking=True)`` on a
CUDA stream owned by each transfer worker: a host-to-device DMA, not a
kernel. Each span's bytes go into a fresh device ``uint8`` allocation and
are viewed as their dtype there, because the safetensors layout does not
align data (the JAX writer pads nothing) and torch cannot view a ``uint8``
slice at an odd offset as a wider dtype. A tensor counts as on the device
once its copy's event has completed.

Safetensors layout: u64-LE header length, then a JSON header mapping tensor
name → {dtype, shape, data_offsets=[begin, end)} relative to the end of the
header, then the packed tensor data.
"""

from __future__ import annotations

import json
import logging
import queue
import struct
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dragonfly2_tpu_torch.device import default_device

logger = logging.getLogger(__name__)

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8,
    "U64": torch.uint64, "U32": torch.uint32, "U16": torch.uint16,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_TORCH_NAMES = {v: k for k, v in _DTYPES.items()}
# numpy dtypes by name, so a bfloat16 array (ml_dtypes) is recognized
# without importing ml_dtypes.
_NUMPY_NAMES = {
    "float64": "F64", "float32": "F32", "float16": "F16", "bfloat16": "BF16",
    "int64": "I64", "int32": "I32", "int16": "I16", "int8": "I8",
    "uint64": "U64", "uint32": "U32", "uint16": "U16", "uint8": "U8",
    "bool": "BOOL",
}


def _dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported safetensors dtype {name!r}") from None


@dataclass(frozen=True)
class TensorSpec:
    name: str
    dtype: str
    shape: Tuple[int, ...]
    start: int  # absolute offset in the file
    end: int

    @property
    def nbytes(self) -> int:
        return self.end - self.start


def parse_safetensors_header(raw: bytes) -> Tuple[List[TensorSpec], int]:
    """Parse a safetensors header prefix → (specs, data_start_offset).

    ``raw`` must contain at least the 8-byte length and the full JSON
    header; tensor offsets are rebased to absolute file offsets.
    """
    if len(raw) < 8:
        raise ValueError("need at least 8 bytes for the header length")
    (header_len,) = struct.unpack("<Q", raw[:8])
    if len(raw) < 8 + header_len:
        raise ValueError(f"header incomplete: have {len(raw)}, "
                         f"need {8 + header_len}")
    header = json.loads(raw[8:8 + header_len])
    data_start = 8 + header_len
    specs = []
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        specs.append(TensorSpec(
            name=name, dtype=info["dtype"], shape=tuple(info["shape"]),
            start=data_start + begin, end=data_start + end,
        ))
    specs.sort(key=lambda s: s.start)
    return specs, data_start


def _dtype_name_and_bytes(arr) -> Tuple[str, bytes]:
    if isinstance(arr, torch.Tensor):
        flat = arr.detach().to("cpu").contiguous().reshape(-1)
        try:
            name = _TORCH_NAMES[flat.dtype]
        except KeyError:
            raise ValueError(f"unsupported dtype {flat.dtype}") from None
        return name, flat.view(torch.uint8).numpy().tobytes()
    try:
        name = _NUMPY_NAMES[arr.dtype.name]
    except KeyError:
        raise ValueError(f"unsupported dtype {arr.dtype}") from None
    return name, np.ascontiguousarray(arr).tobytes()


def write_safetensors(path: str, tensors: Dict[str, object],
                      metadata: Dict[str, str] | None = None) -> None:
    """Minimal safetensors writer (test fixtures + export path).

    ``tensors`` maps names to numpy arrays or torch tensors; for the same
    tensors the file is byte for byte the JAX package's writer's.
    """
    header: Dict[str, dict] = {}
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        dtype, raw = _dtype_name_and_bytes(arr)
        header[name] = {
            "dtype": dtype,
            "shape": [int(d) for d in arr.shape],
            "data_offsets": [offset, offset + len(raw)],
        }
        blobs.append(raw)
        offset += len(raw)
    if metadata:
        header["__metadata__"] = metadata
    header_json = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header_json)))
        f.write(header_json)
        for blob in blobs:
            f.write(blob)


class _Coverage:
    """Merged interval set tracking which byte ranges have arrived."""

    def __init__(self) -> None:
        self._spans: List[Tuple[int, int]] = []

    def add(self, start: int, end: int) -> None:
        spans = self._spans
        spans.append((start, end))
        spans.sort()
        merged = [spans[0]]
        for s, e in spans[1:]:
            if s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        self._spans = merged

    def covers(self, start: int, end: int) -> bool:
        for s, e in self._spans:
            if s <= start and end <= e:
                return True
            if s > start:
                break
        return False

    def covered_bytes(self) -> int:
        return sum(e - s for s, e in self._spans)


class HBMSink:
    """Reassembles unordered pieces and streams completed tensors to the
    card.

    ``device`` is where tensors land: ``None`` means ``cuda``, and a CUDA
    device on a machine without one raises (the sink never falls back to
    the CPU; pass ``device="cpu"`` for the host). ``device_for(name)``
    overrides the placement per tensor. A tensor split across cards is
    not supported.

    Timings for whoever measures the sink: ``staging_seconds`` (the
    staging allocation, pinned on a CUDA device), ``write_seconds`` (the
    time ``write`` spent copying pieces into staging), ``written_at``
    (``time.perf_counter()`` when the latest write returned), ``landed``
    (name → ``time.perf_counter()`` when the tensor's copy was seen
    complete) and ``copy_ms`` (name → the copy's device time between CUDA
    events).
    """

    def __init__(self, content_length: int, device=None,
                 device_for: Optional[Callable[[str], object]] = None,
                 transfer_workers: int = 2):
        self.content_length = content_length
        self._device = default_device(device)
        self._device_for = device_for
        # Host staging area: the buffer every copy DMAs from. Pinned for
        # a CUDA device, so the copies run asynchronously on the workers'
        # streams; one contiguous allocation keeps each copy a slice.
        t0 = time.perf_counter()
        self._staging = torch.empty(content_length, dtype=torch.uint8,
                                    pin_memory=self._device.type == "cuda")
        self.staging_seconds = time.perf_counter() - t0
        self._host = self._staging.numpy()
        self.write_seconds = 0.0
        self.written_at: Optional[float] = None
        self.landed: Dict[str, float] = {}
        self.copy_ms: Dict[str, float] = {}
        self._coverage = _Coverage()
        self._lock = threading.Lock()
        self._specs: Optional[List[TensorSpec]] = None
        self._pending: List[TensorSpec] = []
        self._arrays: Dict[str, torch.Tensor] = {}
        self._events: List[object] = []
        self._errors: List[str] = []
        self._queue: "queue.Queue[Optional[TensorSpec]]" = queue.Queue()
        self._workers = [
            threading.Thread(target=self._transfer_loop,
                             name=f"hbm-transfer-{i}", daemon=True)
            for i in range(transfer_workers)
        ]
        for w in self._workers:
            w.start()
        self._closed = False

    # -- ingest ------------------------------------------------------------

    def write(self, offset: int, data: bytes) -> None:
        """Absorb one piece at its absolute file offset (any order)."""
        end = offset + len(data)
        if end > self.content_length:
            raise ValueError(f"write [{offset}, {end}) beyond "
                             f"content length {self.content_length}")
        with self._lock:
            t0 = time.perf_counter()
            self._host[offset:end] = np.frombuffer(data, dtype=np.uint8)
            self.write_seconds += time.perf_counter() - t0
            self._coverage.add(offset, end)
            self._maybe_parse_header_locked()
            self._dispatch_ready_locked()
            self.written_at = time.perf_counter()

    def _maybe_parse_header_locked(self) -> None:
        if self._specs is not None:
            return
        if not self._coverage.covers(0, 8):
            return
        (header_len,) = struct.unpack("<Q", self._host[:8].tobytes())
        if not self._coverage.covers(0, 8 + header_len):
            return
        specs, _ = parse_safetensors_header(
            self._host[:8 + header_len + 1].tobytes())
        self._specs = specs
        self._pending = list(specs)
        logger.info("hbm sink: header parsed, %d tensors", len(specs))

    def _dispatch_ready_locked(self) -> None:
        if self._specs is None:
            return
        still_pending = []
        for spec in self._pending:
            if self._coverage.covers(spec.start, spec.end):
                self._queue.put(spec)
            else:
                still_pending.append(spec)
        self._pending = still_pending

    # -- device transfer ---------------------------------------------------

    def _placement(self, name: str) -> torch.device:
        if self._device_for is None:
            return self._device
        return default_device(self._device_for(name))

    def _transfer_loop(self) -> None:
        streams: Dict[torch.device, object] = {}
        while True:
            spec = self._queue.get()
            if spec is None:
                return
            try:
                dev = self._placement(spec.name)
                src = self._staging[spec.start:spec.end]
                if dev.type == "cuda":
                    out, event, ms = self._copy_to_card(src, dev, streams)
                else:
                    out, event, ms = src.to(dev, copy=True), None, None
                arr = out.view(_dtype(spec.dtype)).reshape(spec.shape)
                with self._lock:
                    self._arrays[spec.name] = arr
                    self.landed[spec.name] = time.perf_counter()
                    if event is not None:
                        self._events.append(event)
                        self.copy_ms[spec.name] = ms
            except Exception as exc:
                logger.exception("hbm transfer failed for %s", spec.name)
                with self._lock:
                    self._errors.append(f"{spec.name}: {exc}")

    @staticmethod
    def _copy_to_card(src: torch.Tensor, dev: torch.device, streams: dict):
        """One span's bytes onto ``dev`` on this worker's stream; returns
        once the copy has completed.

        The destination is allocated on the device's current stream, not
        the worker's, so a tensor freed later by its user returns to that
        stream's pool; ``record_stream`` keeps the allocator from reusing
        the block before the worker stream's copy is done. The staging
        slice stays alive (the sink holds it) until the event completes.
        """
        stream = streams.get(dev)
        if stream is None:
            stream = streams[dev] = torch.cuda.Stream(device=dev)
        out = torch.empty(src.numel(), dtype=torch.uint8, device=dev)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            start.record(stream)
            out.copy_(src, non_blocking=True)
            done.record(stream)
        out.record_stream(stream)
        done.synchronize()
        return out, done, start.elapsed_time(done)

    # -- completion --------------------------------------------------------

    def wait(self, timeout: float = 300.0) -> Dict[str, torch.Tensor]:
        """Block until every tensor is on the device; returns name →
        ``torch.Tensor``."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                if self._errors:
                    raise RuntimeError("; ".join(self._errors))
                total = len(self._specs) if self._specs is not None else None
                done = len(self._arrays)
            if total is not None and done >= total and self._queue.empty():
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"hbm sink: {done}/{total} tensors after {timeout}s "
                    f"({self._coverage.covered_bytes()}/{self.content_length} "
                    "bytes covered)")
            time.sleep(0.01)
        self.close()
        for event in self._events:
            event.synchronize()
        return dict(self._arrays)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for _ in self._workers:
            self._queue.put(None)
        for w in self._workers:
            w.join(timeout=10)

    @property
    def tensors_on_device(self) -> int:
        with self._lock:
            return len(self._arrays)


def download_to_hbm(daemon, url: str, *, device=None,
                    device_for: Optional[Callable[[str], object]] = None,
                    timeout: float = 300.0,
                    on_sink: Optional[Callable[[HBMSink], None]] = None,
                    **download_kwargs) -> Dict[str, torch.Tensor]:
    """P2P-download a safetensors file straight into device memory.

    Config #5's entry point: pieces stream into the sink as they verify;
    tensors whose spans complete are copied while the rest of the file
    is still downloading. Content length may be unknown at start (pieces
    buffer as metadata until the length is learned, then flush). Returns
    name → ``torch.Tensor`` on ``device`` (``None`` means ``cuda``).
    ``on_sink`` is called with the sink as soon as it exists, before any
    piece is written to it, for callers that watch its progress.
    """
    lock = threading.Lock()
    state: dict = {"sink": None, "backlog": []}

    def new_sink(length: int) -> HBMSink:
        sink = HBMSink(length, device=device, device_for=device_for)
        if on_sink is not None:
            on_sink(sink)
        return sink

    def ensure_sink(store) -> Optional[HBMSink]:
        if state["sink"] is None:
            length = store.meta.content_length
            if length < 0:
                return None
            state["sink"] = new_sink(length)
            for piece_num in state["backlog"]:
                state["sink"].write(
                    store.meta.pieces[piece_num].start,
                    store.read_piece(num=piece_num),
                )
            state["backlog"].clear()
        return state["sink"]

    def on_piece(store, piece) -> None:
        with lock:
            sink = ensure_sink(store)
            if sink is None:
                state["backlog"].append(piece.num)
                return
            sink.write(piece.start, store.read_piece(num=piece.num))

    result = daemon.download_file(url, piece_sink=on_piece, **download_kwargs)
    if not result.success:
        raise RuntimeError(f"download failed: {result.error}")
    if result.direct_bytes is not None:
        # EMPTY/TINY size-scope fast path: no storage, payload is inline.
        sink = new_sink(len(result.direct_bytes))
        sink.write(0, result.direct_bytes)
        return sink.wait(timeout=timeout)
    store = result.storage
    with lock:
        sink = ensure_sink(store)
        if sink is None:
            raise RuntimeError("content length never learned")
        # Reuse fast path (or a raced hook): feed any pieces the hook
        # never saw.
        seen = sink._coverage.covered_bytes()
        if seen < store.meta.content_length:
            for num in store.existing_piece_nums():
                piece = store.meta.pieces[num]
                if not sink._coverage.covers(piece.start,
                                             piece.start + piece.length):
                    sink.write(piece.start, store.read_piece(num=num))
    return sink.wait(timeout=timeout)
