"""Shuffle codecs: pluggable wire formats for the shuffle stage (PyTorch).

The port of ``repro.mapreduce.codecs``: a registry of codecs, each with

- the static ``nbytes`` accounting and ``error_bound``;
- the host engine's ``encode(x) -> EncodedShuffle`` / ``decode`` /
  ``roundtrip``, whole-payload transforms (int8: cross-row 256-element
  blocks through ``core/compression.py``, whose quantize kernels run on the
  card);
- the device engine's ``encode_device(x) -> wire tensors`` /
  ``decode_device(*wire) -> float32``: row-wise layouts the shuffle can
  scatter in the wire dtype, decoded on the device in the reduce.

Every transform runs on the device of the tensor it is given.

Parity: the wire tensors are bit-identical to the JAX package's. That needs
round-half-to-even (``torch.round``), IEEE division, and every constant held
in f32. PyTorch on CUDA turns a division by a Python scalar into a
multiplication by its reciprocal, which is not IEEE division, so every
divisor here is a tensor on the payload's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import compression


def f32_scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded once to f32, as a 0-d tensor on ``like``'s device."""
    return torch.tensor(np.float32(value), device=like.device)


def _f32_tensor(x) -> torch.Tensor:
    """A float32 tensor of ``x`` (numpy arrays land on the CPU)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32))


@dataclasses.dataclass
class EncodedShuffle:
    """A shuffle payload as it would cross the wire."""
    codec: str
    arrays: tuple                 # wire tensors (dtype = wire format)
    shape: tuple                  # original logical shape
    wire_bytes: int


class ShuffleCodec:
    """Interface: host and device transforms + byte accounting. Subclass and
    register."""

    name: str = "base"
    exact: bool = False        # True iff decode(encode(x)) == x bit-for-bit

    def nbytes(self, n_elements: int) -> int:
        """Wire bytes for a payload of ``n_elements`` scalars."""
        raise NotImplementedError

    def error_bound(self, x) -> float:
        """Max elementwise |x - decode(encode(x))| for in-domain inputs."""
        raise NotImplementedError

    def encode(self, x) -> EncodedShuffle:
        """Tensor (or numpy array, taken as a CPU tensor) -> the wire
        payload, on the tensor's device."""
        raise NotImplementedError

    def decode(self, enc: EncodedShuffle) -> torch.Tensor:
        raise NotImplementedError

    def roundtrip(self, x) -> torch.Tensor:
        """What the reducers see after the payload crosses the shuffle, as
        a float32 tensor on ``x``'s device."""
        x = _f32_tensor(x)
        if self.exact:
            return x                  # skip the no-op wire trip
        return self.decode(self.encode(x))

    def encode_device(self, x: torch.Tensor) -> tuple:
        """[n, d] float32 -> tuple of wire tensors with leading axis n."""
        raise NotImplementedError

    def decode_device(self, *wire) -> torch.Tensor:
        """Wire tensors of any [..., d] layout -> float32 [..., d]."""
        raise NotImplementedError

    def device_bytes_per_item(self, d: int) -> int:
        """Wire bytes one [d]-item row occupies on the device shuffle."""
        raise NotImplementedError


class IdentityCodec(ShuffleCodec):
    """float32 passthrough — the uncompressed-shuffle baseline."""

    name = "identity"
    exact = True

    def nbytes(self, n_elements: int) -> int:
        return 4 * n_elements

    def error_bound(self, x) -> float:
        return 0.0

    def encode(self, x):
        x = _f32_tensor(x)
        return EncodedShuffle(self.name, (x,), tuple(x.shape),
                              self.nbytes(x.numel()))

    def decode(self, enc):
        return enc.arrays[0].reshape(enc.shape)

    def encode_device(self, x):
        return (x.to(torch.float32),)

    def decode_device(self, *wire):
        return wire[0]

    def device_bytes_per_item(self, d: int) -> int:
        return 4 * d


class Int16Codec(ShuffleCodec):
    """Fixed-point int16 over the domain [-max_abs, max_abs] (2x smaller)."""

    name = "int16"

    def __init__(self, max_abs: float = 1.0):
        self.max_abs = float(max_abs)

    def nbytes(self, n_elements: int) -> int:
        return 2 * n_elements

    def error_bound(self, x) -> float:
        return self.max_abs / 32767.0

    def encode(self, x):
        x = _f32_tensor(x)
        (q,) = self.encode_device(x)
        return EncodedShuffle(self.name, (q,), tuple(x.shape),
                              self.nbytes(x.numel()))

    def decode(self, enc):
        return self.decode_device(*enc.arrays).reshape(enc.shape)

    def encode_device(self, x):
        q = torch.round(x * f32_scalar(32767.0 / self.max_abs, x))
        return (torch.clamp(q, -32767, 32767).to(torch.int16),)

    def decode_device(self, *wire):
        q = wire[0]
        return q.to(torch.float32) * f32_scalar(self.max_abs / 32767.0, q)

    def device_bytes_per_item(self, d: int) -> int:
        return 2 * d


class Int8BlockCodec(ShuffleCodec):
    """int8 codes with fp32 max-abs scales (~4x smaller). The host
    ``encode``/``decode`` quantize the flattened payload in ``block``-element
    blocks (``core/compression.py``, the kernels on the card); the device
    layout keeps one scale per row, so the shuffle can scatter rows on
    their own (same error bound, different results)."""

    name = "int8"

    def __init__(self, block: int = 0):
        self.block = int(block) or compression.BLOCK

    def nbytes(self, n_elements: int) -> int:
        return compression.int8_wire_bytes(n_elements, self.block)

    def error_bound(self, x) -> float:
        x = _f32_tensor(x)
        return float(x.abs().max()) / 127.0 if x.numel() else 0.0

    def encode(self, x):
        x = _f32_tensor(x)
        q, scale, _ = compression.quantize_block(x.reshape(-1), self.block)
        return EncodedShuffle(self.name, (q, scale), tuple(x.shape),
                              self.nbytes(x.numel()))

    def decode(self, enc):
        q, scale = enc.arrays
        n = int(np.prod(enc.shape)) if enc.shape else 1
        return compression.dequantize_block(q, scale, n,
                                            block=self.block).reshape(enc.shape)

    def encode_device(self, x):
        amax = torch.clamp_min(x.abs().amax(dim=-1), 1e-12)
        scale = amax / f32_scalar(127.0, x)
        q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
        return (q.to(torch.int8), scale.to(torch.float32))

    def decode_device(self, *wire):
        q, scale = wire
        return q.to(torch.float32) * scale[..., None]

    def device_bytes_per_item(self, d: int) -> int:
        return d + 4


_REGISTRY: dict[str, ShuffleCodec] = {}


def register_codec(codec: ShuffleCodec, *, overwrite: bool = False) -> ShuffleCodec:
    """Add a codec instance to the registry under ``codec.name``."""
    if codec.name in _REGISTRY and not overwrite:
        raise ValueError(f"codec {codec.name!r} already registered")
    _REGISTRY[codec.name] = codec
    return codec


def get_codec(codec: str | ShuffleCodec) -> ShuffleCodec:
    """Resolve a codec by registry name (instances pass through)."""
    if isinstance(codec, ShuffleCodec):
        return codec
    try:
        return _REGISTRY[codec]
    except KeyError:
        raise KeyError(f"unknown shuffle codec {codec!r}; "
                       f"available: {available_codecs()}") from None


def available_codecs() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_codec(IdentityCodec())
register_codec(Int16Codec())
register_codec(Int8BlockCodec())
