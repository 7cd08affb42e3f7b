"""Distance codecs: the storage half of the storage/compute dtype split.

A codec maps the f32 label-distance plane to a narrower storage dtype;
every consumer (the query intersection, cross-shard minimums,
``to_table``) dequantizes back to f32 before any arithmetic, so compute
semantics never change, only residency does. Three codecs:

- ``"bf16"``: f32 truncated to bfloat16 by the round-to-nearest-even
  bit trick, stored as u16 (+inf survives exactly). 2 bytes.
- ``"u16"`` / ``"u32"``: fixed point against a per-shard scale, the
  dtype's max value reserved as the +inf/pad sentinel. In **exact
  mode** the scale is 1.0 and the encoder proves the round trip
  bit-identical (integer-weight graphs), refusing with a typed error
  otherwise. Lossy mode picks ``scale = max / (max_code)`` (rounded to
  f32) and reports the measured max ulp error instead.

Encoding runs in host numpy, a copy of the reference package's
encoder, so codes, scales and ``max_ulp`` match it byte for byte.
Decoding has a numpy form (``to_table``, host analysis) and a torch
form, `decode_dist_torch`, which runs on the codes' device inside the
compressed store's query.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["DIST_CODECS", "QuantizationError", "QuantPrecisionError",
           "QuantRangeError", "decode_dist_np", "decode_dist_torch",
           "code_array", "code_tensor", "encode_dist", "max_ulp_error",
           "widen_codes"]

#: distance codecs a BuildPlan / CHLIndex.load may request
DIST_CODECS = ("bf16", "u16", "u32")

_FIXED = {"u16": np.uint16, "u32": np.uint32}


class QuantizationError(ValueError):
    """A distance codec cannot (or refuses to) represent the labels it
    was asked to encode. Subclasses ``ValueError`` like the other
    artifact-misuse errors."""


class QuantRangeError(QuantizationError):
    """Exact mode: the max label distance (a diameter bound) exceeds
    the codec's representable range — encoding would clip, so it is
    refused at encode time instead of serving wrong distances."""


class QuantPrecisionError(QuantizationError):
    """Exact mode: the bitwise round-trip check failed (non-integral
    weights under a fixed-point codec, or mantissas wider than the
    storage dtype) — encoding would round, so it is refused."""


def _valid_mask(dist: np.ndarray) -> np.ndarray:
    return np.isfinite(dist)


def max_ulp_error(orig: np.ndarray, decoded: np.ndarray) -> int:
    """Max f32 ulp distance between original and decoded values over
    the finite entries (both arrays share the +inf/pad layout)."""
    ok = np.isfinite(orig)
    if not ok.any():
        return 0
    a = np.ascontiguousarray(orig[ok], np.float32).view(np.int32)
    b = np.ascontiguousarray(decoded[ok], np.float32).view(np.int32)
    # label distances are non-negative, so the int32 views are ordered
    # like the floats and their difference counts representable steps
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def encode_dist(dist: np.ndarray, codec: str, *, exact: bool = False
                ) -> Tuple[np.ndarray, float, int]:
    """Encode f32 distances (+inf = pad/unreachable) under ``codec``.

    Returns ``(codes, scale, max_ulp)`` — ``scale`` is the per-shard
    fixed-point step (1.0 for bf16/exact), ``max_ulp`` the measured
    max f32 ulp error of the round trip (0 in exact mode, by proof).
    Exact mode raises :class:`QuantRangeError` /
    :class:`QuantPrecisionError` instead of degrading.
    """
    if codec not in DIST_CODECS:
        raise QuantizationError(
            f"unknown distance codec {codec!r}; one of {DIST_CODECS}")
    d = np.ascontiguousarray(dist, np.float32)
    if codec == "bf16":
        bits = d.view(np.uint32)
        # round-to-nearest-even truncation to the top 16 bits; +inf
        # (0x7f80_0000) maps to 0x7f80 and decodes back to +inf
        codes = ((bits + np.uint32(0x7FFF)
                  + ((bits >> np.uint32(16)) & np.uint32(1)))
                 >> np.uint32(16)).astype(np.uint16)
        dec = decode_dist_np(codes, "bf16", 1.0)
        ulp = max_ulp_error(d, dec)
        if exact and ulp:
            raise QuantPrecisionError(
                "exact mode: bf16 cannot represent these label "
                f"distances bit-exactly (max ulp error {ulp}); use "
                "codec='u16'/'u32' on an integer-weight graph, or "
                "lossy mode")
        return codes, 1.0, ulp
    dt = _FIXED[codec]
    info = np.iinfo(dt)
    sentinel = np.uint64(info.max)
    max_code = info.max - 1                  # top value = +inf sentinel
    ok = _valid_mask(d)
    maxf = float(d[ok].max()) if ok.any() else 0.0
    if exact:
        if maxf > max_code:
            raise QuantRangeError(
                f"exact mode: max label distance {maxf:.0f} (a graph "
                f"diameter bound) exceeds the {codec} codec's "
                f"representable range {max_code} at scale=1 — refusing "
                "to clip; use codec='u32' or lossy mode")
        scale = 1.0
        codes = np.where(ok, np.round(np.where(ok, d, 0.0))
                         .astype(np.uint64), sentinel).astype(dt)
        dec = decode_dist_np(codes, codec, scale)
        if not np.array_equal(np.where(ok, dec, 0.0),
                              np.where(ok, d, 0.0)):
            raise QuantPrecisionError(
                f"exact mode: {codec} round trip is not bit-identical "
                "— label distances are not integral f32 (non-integer "
                "edge weights?); use lossy mode or bf16")
        return codes, scale, 0
    scale = float(np.float32(maxf / max_code)) if maxf > 0 else 1.0
    q = np.round(np.where(ok, d, 0.0) / np.float32(scale))
    codes = np.where(ok, np.clip(q, 0, max_code).astype(np.uint64),
                     sentinel).astype(dt)
    ulp = max_ulp_error(d, decode_dist_np(codes, codec, scale))
    return codes, scale, ulp


def decode_dist_np(codes: np.ndarray, codec: str, scale: float
                   ) -> np.ndarray:
    """Host-numpy dequant back to f32 (+inf for the sentinel)."""
    if codec == "bf16":
        return (np.ascontiguousarray(codes, np.uint16)
                .astype(np.uint32) << np.uint32(16)).view(np.float32)
    info = np.iinfo(_FIXED[codec])
    return np.where(codes == info.max, np.float32(np.inf),
                    codes.astype(np.float32) * np.float32(scale))


#: bits of each storage width; a narrow unsigned code is held on the
#: device as the signed tensor of its width (the same bits)
_WIDTH_BITS = {torch.uint8: 8, torch.int16: 16, torch.uint16: 16,
               torch.int32: 32, torch.uint32: 32}


#: the host dtype whose tensor holds each unsigned storage dtype's bits
#: on a device (u8 is a torch dtype of its own)
_HOLDER = {np.dtype(np.uint8): np.uint8, np.dtype(np.uint16): np.int16,
           np.dtype(np.uint32): np.int32}


def code_tensor(codes: np.ndarray, device) -> torch.Tensor:
    """A host code array (u8/u16/u32) on ``device``, u16/u32 held as
    the int16/int32 tensor of the same bits (a fresh copy: never a view
    of a memory map)."""
    a = np.ascontiguousarray(codes)
    return torch.from_numpy(a.view(_HOLDER[a.dtype]).copy()).to(device)


def code_array(codes: torch.Tensor, dtype) -> np.ndarray:
    """The host array of a code tensor in its storage dtype ``dtype``
    (the reverse of `code_tensor`)."""
    return codes.cpu().numpy().view(np.dtype(dtype))


def widen_codes(codes: torch.Tensor) -> torch.Tensor:
    """The unsigned values of a code tensor as int64: a ``uint8``,
    ``uint16`` or ``uint32`` tensor, or the ``int16``/``int32`` tensor
    holding a u16/u32 code's bits. No arithmetic runs in the narrow
    dtype."""
    bits = _WIDTH_BITS.get(codes.dtype)
    if bits is None:
        raise TypeError(f"not a code tensor: {codes.dtype}")
    return codes.to(torch.int64) & ((1 << bits) - 1)


def decode_dist_torch(codes: torch.Tensor, codec: str, scale: float
                      ) -> torch.Tensor:
    """Dequant on the codes' device, equal to `decode_dist_np` bit for
    bit: bf16 moves the code to the top half of an f32; fixed point
    multiplies the f32-rounded code by the f32 scale (``scale`` is
    f32-representable, so the product is numpy's f32 product) and maps
    the all-ones sentinel to +inf. No host-to-device copy."""
    if codec == "bf16":
        return (codes.to(torch.int32) << 16).view(torch.float32)
    w = widen_codes(codes)
    return (w.to(torch.float32) * scale).masked_fill_(
        w == int(np.iinfo(_FIXED[codec]).max), torch.inf)
