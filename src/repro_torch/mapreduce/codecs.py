"""Shuffle codecs: pluggable wire formats for the shuffle stage (PyTorch).

The port of ``repro.mapreduce.codecs``' device half: a registry of codecs,
each with the static ``nbytes`` accounting and the device transforms
``encode_device(x) -> wire tensors`` / ``decode_device(*wire) -> float32``
that the device engine's shuffle and reduce run. The shuffle scatters
payloads in the wire dtype (int16/int8) and the reduce decodes them on the
device, so shuffle traffic shrinks with the codec ratio.

Parity: the wire tensors are bit-identical to the JAX package's. That needs
round-half-to-even (``torch.round``), IEEE division, and every constant held
in f32. PyTorch on CUDA turns a division by a Python scalar into a
multiplication by its reciprocal, which is not IEEE division, so every
divisor here is a tensor on the payload's device.
"""
from __future__ import annotations

import numpy as np
import torch


def f32_scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded once to f32, as a 0-d tensor on ``like``'s device."""
    return torch.tensor(np.float32(value), device=like.device)


class ShuffleCodec:
    """Interface: device transforms + byte accounting. Subclass and register."""

    name: str = "base"

    def nbytes(self, n_elements: int) -> int:
        """Wire bytes for a payload of ``n_elements`` scalars."""
        raise NotImplementedError

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

    def nbytes(self, n_elements: int) -> int:
        return 4 * n_elements

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

    def encode_device(self, x):
        q = torch.round(x * f32_scalar(32767.0 / self.max_abs, x))
        return (torch.clamp(q, -32767, 32767).to(torch.int16),)

    def decode_device(self, *wire):
        q = wire[0]
        return q.to(torch.float32) * f32_scalar(self.max_abs / 32767.0, q)

    def device_bytes_per_item(self, d: int) -> int:
        return 2 * d


class Int8BlockCodec(ShuffleCodec):
    """int8 codes with one fp32 max-abs scale per row on the device (~4x
    smaller at d=3 once the scale is counted). ``nbytes`` keeps the JAX
    package's host accounting: one fp32 scale per ``block`` elements."""

    name = "int8"

    def __init__(self, block: int = 256):
        self.block = int(block)

    def nbytes(self, n_elements: int) -> int:
        n_pad = ((max(n_elements, 1) + self.block - 1) // self.block) * self.block
        return n_pad + 4 * (n_pad // self.block)

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
