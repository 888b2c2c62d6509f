"""Port parity for the device-memory sink (BASELINE config #5):
``dragonfly2_tpu_torch/client/hbm_sink.py`` against the JAX package's
``client/hbm_sink.py``, on the CPU (``device="cpu"`` on the port's side,
the CPU JAX device on the reference's).

Tolerance: none. Tensors are compared as raw bytes with their shapes and
dtype names, so the port's tensors must be bit-equal to ``np.asarray`` of
JAX's arrays and to the arrays the file was written from; files written
by the two writers must be byte-equal. JAX without 64-bit mode narrows
F64, I64 and U64 tensors as ``device_put`` places them, so those are held
to the written arrays only.
"""

from __future__ import annotations

import struct
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from dragonfly2_tpu.client import hbm_sink as jsink
from dragonfly2_tpu_torch.client import hbm_sink as psink
from dragonfly2_tpu_torch.device import DeviceFault

# safetensors dtype name → the numpy dtype the JAX package reads it as.
NUMPY_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "BF16": ml_dtypes.bfloat16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}


def make_tensors(seed: int = 0) -> dict:
    """``tests/test_hbm_sink.py``'s tensors plus a BF16 one."""
    rng = np.random.default_rng(seed)
    return {
        "embed.weight": rng.normal(size=(256, 64)).astype(np.float32),
        "layer0.w": rng.normal(size=(64, 128)).astype(np.float32),
        "layer0.b": rng.normal(size=(128,)).astype(np.float32),
        "head.weight": rng.normal(size=(128, 32)).astype(np.float16),
        "counts": rng.integers(0, 100, size=(7,)).astype(np.int32),
        "norm.bf16": rng.normal(size=(3, 33)).astype(ml_dtypes.bfloat16),
    }


def every_dtype(seed: int = 0) -> dict:
    """One tensor of each safetensors dtype, with odd sizes so that every
    later tensor starts at an offset its element size does not divide."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, (name, dtype) in enumerate(NUMPY_DTYPES.items()):
        shape = (3, 5 + i)
        if name == "BOOL":
            arr = rng.integers(0, 2, size=shape).astype(np.bool_)
        else:
            bits = rng.integers(0, 256, size=(int(np.prod(shape))
                                              * np.dtype(dtype).itemsize,),
                                dtype=np.uint8)
            arr = bits.view(dtype).reshape(shape)
        out[f"t.{name.lower()}"] = arr
    out["t.scalar"] = np.float32(1.5).reshape(())
    out["t.empty"] = np.zeros((0, 4), np.float32)
    return out


def to_torch(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def tensor_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def assert_same(port: dict, ref: dict) -> None:
    """Port tensors against JAX arrays (or numpy arrays): names, shapes,
    dtypes and every byte."""
    assert set(port) == set(ref)
    for name, arr in ref.items():
        got = port[name]
        want = np.asarray(arr)
        assert tuple(got.shape) == want.shape, name
        assert psink._TORCH_NAMES[got.dtype] == psink._NUMPY_NAMES[
            want.dtype.name], name
        assert tensor_bytes(got) == np.ascontiguousarray(want).tobytes(), name


def assert_same_as_jax(port: dict, ref: dict) -> None:
    assert set(port) == set(ref)
    assert_same({k: v for k, v in port.items()
                 if v.dtype not in (torch.float64, torch.int64, torch.uint64)},
                {k: v for k, v in ref.items()
                 if port[k].dtype not in (torch.float64, torch.int64,
                                          torch.uint64)})


def write_file(tmp_path, tensors, metadata=None, name="m.safetensors"):
    path = str(tmp_path / name)
    jsink.write_safetensors(path, tensors, metadata=metadata)
    return open(path, "rb").read()


def feed(sink, raw: bytes, offsets, piece: int) -> None:
    for off in offsets:
        sink.write(off, raw[off:off + piece])


class TestCodec:
    @pytest.mark.parametrize("kind", ["model", "every_dtype"])
    def test_jax_files_parse_to_the_same_specs(self, tmp_path, kind):
        tensors = make_tensors() if kind == "model" else every_dtype()
        raw = write_file(tmp_path, tensors, metadata={"format": "pt"})
        jspecs, jstart = jsink.parse_safetensors_header(raw)
        pspecs, pstart = psink.parse_safetensors_header(raw)
        assert pstart == jstart
        assert [(s.name, s.dtype, s.shape, s.start, s.end, s.nbytes)
                for s in pspecs] == [
            (s.name, s.dtype, s.shape, s.start, s.end, s.nbytes)
            for s in jspecs]

    @pytest.mark.parametrize("as_torch", [False, True])
    @pytest.mark.parametrize("kind", ["model", "every_dtype"])
    def test_writer_is_byte_equal_to_jax(self, tmp_path, kind, as_torch):
        tensors = make_tensors(1) if kind == "model" else every_dtype(1)
        want = write_file(tmp_path, tensors, metadata={"format": "pt"})
        given = ({k: to_torch(v) for k, v in tensors.items()} if as_torch
                 else tensors)
        path = str(tmp_path / "port.safetensors")
        psink.write_safetensors(path, given, metadata={"format": "pt"})
        assert open(path, "rb").read() == want

    @pytest.mark.parametrize("name", sorted(NUMPY_DTYPES))
    def test_every_dtype_maps_to_torch(self, name):
        itemsize = np.dtype(NUMPY_DTYPES[name]).itemsize
        assert psink._dtype(name).itemsize == itemsize
        raw = torch.arange(4 * itemsize, dtype=torch.uint8)
        view = raw.view(psink._dtype(name)).reshape(2, 2)
        assert tensor_bytes(view) == raw.numpy().tobytes()

    def test_unknown_dtype_and_short_header_raise(self):
        with pytest.raises(ValueError):
            psink._dtype("F8_E4M3")
        with pytest.raises(ValueError):
            psink.parse_safetensors_header(b"\x00" * 4)
        with pytest.raises(ValueError):
            psink.parse_safetensors_header(struct.pack("<Q", 100) + b"{}")


def jax_result(raw: bytes, offsets, piece: int) -> dict:
    sink = jsink.HBMSink(len(raw))
    feed(sink, raw, offsets, piece)
    return sink.wait(timeout=60)


def port_result(raw: bytes, offsets, piece: int) -> dict:
    sink = psink.HBMSink(len(raw), device="cpu")
    feed(sink, raw, offsets, piece)
    return sink.wait(timeout=60)


class TestSinkAgainstJax:
    @pytest.mark.parametrize("order", ["in_order", "reversed", "shuffled"])
    @pytest.mark.parametrize("piece", [7, 1000, 4096])
    def test_piece_orders(self, tmp_path, order, piece):
        tensors = make_tensors(2)
        raw = write_file(tmp_path, tensors)
        offsets = list(range(0, len(raw), piece))
        if order == "reversed":
            offsets.reverse()  # the header arrives last
        elif order == "shuffled":
            np.random.default_rng(piece).shuffle(offsets)
        got = port_result(raw, offsets, piece)
        assert_same_as_jax(got, jax_result(raw, offsets, piece))
        assert_same(got, tensors)

    @pytest.mark.parametrize("pad", range(8))
    def test_unaligned_header_every_dtype(self, tmp_path, pad):
        """Metadata of 8 lengths gives every header length mod 8, so the
        data (and each wide tensor after an odd-sized one) starts at
        offsets no element size divides."""
        tensors = every_dtype(3)
        raw = write_file(tmp_path, tensors, metadata={"pad": "x" * pad})
        offsets = list(range(0, len(raw), 333))[::-1]
        got = port_result(raw, offsets, 333)
        assert_same_as_jax(got, jax_result(raw, offsets, 333))
        assert_same(got, tensors)

    def test_header_lengths_cover_every_residue(self, tmp_path):
        starts = set()
        for pad in range(8):
            raw = write_file(tmp_path, every_dtype(3),
                             metadata={"pad": "x" * pad})
            starts.add(psink.parse_safetensors_header(raw)[1] % 8)
        assert starts == set(range(8))

    def test_eager_transfer_before_completion(self, tmp_path):
        """A tensor whose span is complete lands while later bytes are
        still missing, in both packages."""
        raw = write_file(tmp_path, make_tensors())
        specs, _ = psink.parse_safetensors_header(raw)
        first = specs[0]
        for sink in (psink.HBMSink(len(raw), device="cpu"),
                     jsink.HBMSink(len(raw))):
            sink.write(0, raw[:first.end])  # header + first tensor only
            deadline = time.monotonic() + 30
            while sink.tensors_on_device < 1:
                assert time.monotonic() < deadline, "first tensor never landed"
                time.sleep(0.01)
            assert sink.tensors_on_device == 1
            sink.write(first.end, raw[first.end:])
            assert len(sink.wait(timeout=60)) == len(specs)

    def test_write_past_end_rejected(self):
        for sink in (psink.HBMSink(100, device="cpu"), jsink.HBMSink(100)):
            with pytest.raises(ValueError) as err:
                sink.write(90, b"x" * 20)
            sink.close()
            assert "beyond content length 100" in str(err.value)

    def test_timeout_reports_the_same_progress(self, tmp_path):
        raw = write_file(tmp_path, make_tensors())
        messages = []
        for sink in (psink.HBMSink(len(raw), device="cpu"),
                     jsink.HBMSink(len(raw))):
            sink.write(0, raw[:2000])  # header only, tensors incomplete
            with pytest.raises(TimeoutError) as err:
                sink.wait(timeout=0.2)
            sink.close()
            messages.append(str(err.value))
        assert messages[0] == messages[1]
        assert messages[0].startswith("hbm sink: 0/6 tensors after 0.2s "
                                      f"(2000/{len(raw)} bytes covered)")

    def test_concurrent_writers_and_workers(self, tmp_path):
        """More writer threads and transfer workers than cores, with a
        short switch interval: every tensor still lands bit-equal once."""
        import sys
        import threading

        tensors = make_tensors(6)
        raw = write_file(tmp_path, tensors)
        offsets = list(range(0, len(raw), 512))
        np.random.default_rng(6).shuffle(offsets)
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            sink = psink.HBMSink(len(raw), device="cpu", transfer_workers=12)
            writers = [threading.Thread(
                target=feed, args=(sink, raw, offsets[i::16], 512))
                for i in range(16)]
            for w in writers:
                w.start()
            for w in writers:
                w.join(timeout=60)
            assert not any(w.is_alive() for w in writers)
            got = sink.wait(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert_same(got, tensors)
        assert set(sink.landed) == set(tensors)

    def test_placement_failure_is_an_error_not_a_cpu_tensor(self, tmp_path):
        """``device_for`` sending a tensor to a device that cannot take it
        makes ``wait`` raise; nothing lands on the CPU in its place."""
        if torch.cuda.is_available():
            pytest.skip("needs a machine without a CUDA device")
        raw = write_file(tmp_path, make_tensors())
        sink = psink.HBMSink(
            len(raw), device="cpu",
            device_for=lambda n: "cuda" if n == "layer0.b" else "cpu")
        sink.write(0, raw)
        with pytest.raises(RuntimeError, match="layer0.b"):
            sink.wait(timeout=30)
        sink.close()


    def test_sharded_placement_on_mesh(self, tmp_path):
        """``shard_for`` splits dim 0 as the JAX sink's ``sharding_for``
        does with ``PartitionSpec("data")`` (``tests/test_hbm_sink.py``'s
        ``test_sharded_placement_on_mesh``, on a 2-device mesh): the sinks
        of ranks 0 and 1 each hold the JAX array's shard on device 0 and
        1, bit for bit, and half the tensor's bytes; every other tensor
        lands whole in both."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec

        from dragonfly2_tpu.parallel import data_parallel_mesh

        mesh = data_parallel_mesh(devices=jax.devices()[:2])
        sharding = NamedSharding(mesh.mesh, PartitionSpec("data"))
        replicated = NamedSharding(mesh.mesh, PartitionSpec())
        tensors = make_tensors(seed=3)
        raw = write_file(tmp_path, tensors)
        offsets = list(range(0, len(raw), 4096))
        jax_sink = jsink.HBMSink(len(raw), sharding_for=lambda name: (
            sharding if name == "embed.weight" else replicated))
        feed(jax_sink, raw, offsets, 4096)
        embed = jax_sink.wait(timeout=60)["embed.weight"]
        shards = {s.device: np.asarray(s.data)
                  for s in embed.addressable_shards}
        whole = tensors["embed.weight"]
        for rank, device in enumerate(mesh.mesh.devices.flat):
            sink = psink.HBMSink(
                len(raw), device="cpu", shard_for=lambda name, rank=rank: (
                    (2, rank) if name == "embed.weight" else None))
            feed(sink, raw, offsets, 4096)
            got = sink.wait(timeout=60)
            block = got.pop("embed.weight")
            assert tensor_bytes(block) == shards[device].tobytes()
            assert tuple(block.shape) == shards[device].shape
            assert block.numel() * block.element_size() == whole.nbytes // 2
            assert_same(got, {k: v for k, v in tensors.items()
                              if k != "embed.weight"})

    @pytest.mark.parametrize("shard", [(3, 0), (2, 2)])
    def test_sharded_placement_refuses_an_uneven_split(self, tmp_path,
                                                       shard):
        """A world that does not divide the rows, or a rank outside it,
        makes ``wait`` raise with the tensor's name."""
        raw = write_file(tmp_path, make_tensors())
        sink = psink.HBMSink(len(raw), device="cpu", shard_for=lambda n: (
            shard if n == "embed.weight" else None))
        sink.write(0, raw)
        with pytest.raises(RuntimeError, match="embed.weight"):
            sink.wait(timeout=30)
        sink.close()


class TestDevice:
    @pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
    def test_cuda_without_a_card_raises(self, device):
        if torch.cuda.is_available():
            pytest.skip("needs a machine without a CUDA device")
        with pytest.raises(DeviceFault):
            psink.HBMSink(100, device=device)

    def test_download_to_hbm_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("needs a machine without a CUDA device")
        daemon = FakeDaemon(b"\x00" * 64, pieces=[(0, 64)], length_known=True)
        with pytest.raises(DeviceFault):
            psink.download_to_hbm(daemon, "http://origin/m.safetensors")


# -- download_to_hbm's own paths, through a stand-in daemon -----------------

class _Meta:
    def __init__(self, length):
        self.content_length = length
        self.pieces = {}


class _Piece:
    def __init__(self, num, start, length):
        self.num, self.start, self.length = num, start, length


class _Store:
    def __init__(self, raw, length_known):
        self.raw = raw
        self.meta = _Meta(len(raw) if length_known else -1)

    def read_piece(self, num):
        p = self.meta.pieces[num]
        return self.raw[p.start:p.start + p.length]

    def existing_piece_nums(self):
        return sorted(self.meta.pieces)


class _Result:
    def __init__(self, storage=None, direct_bytes=None):
        self.success, self.error = True, ""
        self.storage, self.direct_bytes = storage, direct_bytes


class FakeDaemon:
    """``download_file`` as the conductor drives the hook: each piece is
    stored, then handed to ``piece_sink``. ``length_known=False`` keeps
    the content length unknown (-1) until ``learn_after`` pieces have
    arrived; ``hooked`` pieces reach the hook, the rest only the store
    (the reuse path's shape); ``direct`` returns the payload inline."""

    def __init__(self, raw, pieces, length_known=True, learn_after=0,
                 hooked=None, direct=False):
        self.raw, self.pieces = raw, pieces
        self.length_known, self.learn_after = length_known, learn_after
        self.hooked, self.direct = hooked, direct

    def download_file(self, url, piece_sink=None):
        if self.direct:
            return _Result(direct_bytes=self.raw)
        store = _Store(self.raw, self.length_known)
        for i, (start, length) in enumerate(self.pieces):
            if i == self.learn_after:
                store.meta.content_length = len(self.raw)
            store.meta.pieces[i] = _Piece(i, start, length)
            if self.hooked is None or i in self.hooked:
                piece_sink(store, store.meta.pieces[i])
        store.meta.content_length = len(self.raw)
        return _Result(storage=store)


def pieces_of(raw: bytes, size: int):
    return [(s, min(size, len(raw) - s)) for s in range(0, len(raw), size)]


class TestDownloadToHbm:
    @pytest.mark.parametrize("case", ["known", "backlog", "reuse", "direct"])
    def test_paths_match_jax(self, tmp_path, case):
        tensors = make_tensors(5)
        raw = write_file(tmp_path, tensors)
        pieces = pieces_of(raw, 5000)[::-1]
        kwargs = {
            "known": {},
            # unknown length for the first 3 hooked pieces: they wait in
            # the backlog and flush when the sink is created
            "backlog": {"length_known": False, "learn_after": 3},
            # the hook sees only every other piece; the rest come from
            # the store after download_file returns
            "reuse": {"hooked": set(range(0, len(pieces), 2))},
            "direct": {"direct": True},
        }[case]
        want = jsink.download_to_hbm(FakeDaemon(raw, pieces, **kwargs),
                                     "http://origin/m", timeout=60)
        seen = []
        got = psink.download_to_hbm(FakeDaemon(raw, pieces, **kwargs),
                                    "http://origin/m", device="cpu",
                                    timeout=60, on_sink=seen.append)
        assert_same_as_jax(got, want)
        assert_same(got, tensors)
        assert len(seen) == 1 and seen[0].content_length == len(raw)
        assert set(seen[0].landed) == set(tensors)
