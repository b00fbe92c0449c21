"""Single-transfer frame upload codec for the online serving path.

Each frame travels host -> device as ONE flat buffer of 16-bit words, the
same layout as the JAX package's codec (a buffer packed by either package
unpacks in the other):

  ``[64-word header | position words | timestamp words]``

header words (little-endian u16):
  [0:2]   valid point count (u32 as lo, hi)
  [2]     has_timestamps flag
  [3]     active flag (1 = real frame; an all-zero buffer is an inactive
          padding frame whose state updates are masked, used by the
          chunk-scan streaming mode to pad partial chunks)
  [4:36]  relative_odometry 4x4 f32, row-major (2 words per value)
  [36:42] position offset xyz f32 (quantized codec)
  [42:48] position scale  xyz f32 (quantized codec)
  [48:64] reserved

body, codec "f32" (lossless, bit-exact round trip):
  positions as raw f32 bits, point-major (6 words/point), then
  timestamps as raw f32 bits (2 words/point).  W = 64 + 8*bucket.

body, codec "u16" (quantized, half the bytes):
  positions as ``round((p - offset) / scale)`` per axis (3 words/point),
  timestamps as ``round(t * 65535)`` (1 word/point).  W = 64 + 4*bucket.
  Per-frame offset/scale come from the frame's bounding box, so the
  worst-case quantization error is ``extent / 2 / 65535`` per axis
  (~0.9 mm at a 120 m scene extent, ~1000x below the voxel size).

The host side is numpy and writes uint16 words.  The device side
(``unpack_frame``) takes the buffer as an int16 tensor (the same bits;
torch has almost no uint16 ops): every f32 field starts on a 4-byte
boundary, so the f32 codec decodes by reinterpreting views, with no
arithmetic.

One rule differs from the JAX codec: timestamps enable deskew only when
there is exactly one per point (JAX's accepts more stamps than points).
"""

from __future__ import annotations

import numpy as np
import torch

HEADER_WORDS = 64
CODECS = ("f32", "u16")


def packed_words(bucket: int, codec: str) -> int:
    """Total 16-bit words for one packed frame at the given point bucket."""
    if codec not in CODECS:
        raise ValueError(f"codec {codec!r}")
    return HEADER_WORDS + (8 if codec == "f32" else 4) * bucket


def packed_bytes(bucket: int, codec: str) -> int:
    return 2 * packed_words(bucket, codec)


# ----------------------------------------------------------------------
# Host side (numpy): pack one frame into a preallocated u16 row.
# ----------------------------------------------------------------------

def _f32_words(values) -> np.ndarray:
    """f32 array -> interleaved (lo, hi) u16 words: on a little-endian host
    a reinterpreting view, which the device side reads back as f32."""
    if not np.little_endian:
        raise RuntimeError("the packing codec needs a little-endian host")
    return np.ascontiguousarray(values, np.float32).view(np.uint16).ravel()


def pack_frame_into(buf: np.ndarray, points, timestamps, relative_odometry,
                    codec: str) -> int:
    """Pack one scan into ``buf`` (a zeroed (W,) u16 row); returns count.

    ``points`` (N, 3) float; ``timestamps`` (N,) in [0, 1] or None;
    ``relative_odometry`` (4, 4).  Points beyond the bucket are the
    caller's to count as truncated.  Timestamps of another length than the
    points disable deskew for the frame.
    """
    bucket = (buf.shape[0] - HEADER_WORDS) // (8 if codec == "f32" else 4)
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    has_ts = (timestamps is not None and len(timestamps) == len(pts)
              and len(pts) > 0)
    n = min(len(pts), bucket)
    pts = pts[:n]
    ts = (np.clip(np.asarray(timestamps, np.float32)[:n], 0.0, 1.0)
          if has_ts else None)

    buf[0] = n & 0xFFFF
    buf[1] = n >> 16
    buf[2] = 1 if has_ts else 0
    buf[3] = 1  # active (zeroed padding buffers stay inactive)
    buf[4:36] = _f32_words(np.asarray(relative_odometry, np.float32))
    if codec == "f32":
        if n:
            buf[HEADER_WORDS:HEADER_WORDS + 6 * n] = _f32_words(pts)
            if has_ts:
                o = HEADER_WORDS + 6 * bucket
                buf[o:o + 2 * n] = _f32_words(ts)
    else:
        if n:
            offset = pts.min(axis=0)
            scale = np.maximum(pts.max(axis=0) - offset, 1e-12) / 65535.0
            # round-half-up via floor(x + 0.5), as the JAX codec does
            q = np.clip((pts - offset) * (1.0 / scale) + 0.5, 0.0, 65535.0)
            buf[36:42] = _f32_words(offset)
            buf[42:48] = _f32_words(scale)
            buf[HEADER_WORDS:HEADER_WORDS + 3 * n] = \
                q.astype(np.uint16).ravel()
            if has_ts:
                o = HEADER_WORDS + 3 * bucket
                buf[o:o + n] = (ts * 65535.0 + 0.5).astype(np.uint16)
    return n


def pack_frame(points, timestamps, relative_odometry, bucket: int,
               codec: str) -> tuple[np.ndarray, int]:
    """Allocate-and-pack convenience wrapper; returns (buf, count)."""
    buf = np.zeros(packed_words(bucket, codec), np.uint16)
    n = pack_frame_into(buf, points, timestamps, relative_odometry, codec)
    return buf, n


# ----------------------------------------------------------------------
# Device side (torch): unpack.
# ----------------------------------------------------------------------

def _u16(w):
    """int16 words -> their unsigned value as int32."""
    return w.to(torch.int32) & 0xFFFF


def unpack_frame(packed, bucket: int, codec: str, return_active=False):
    """(W,) int16 tensor (the bits of a packed u16 buffer) -> (points (B, 3)
    f32, ts (B,), mask (B,), has_timestamps 0-d bool, relative_odometry
    (4, 4) f32[, active 0-d bool]), all on the buffer's device.  The f32
    fields are zero-copy views of the buffer's bits."""
    if codec not in CODECS:
        raise ValueError(f"codec {codec!r}")
    words = packed_words(bucket, codec)
    if packed.dtype != torch.int16 or packed.shape != (words,):
        raise ValueError(f"packed frame must be ({words},) int16; got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    hdr = packed[:HEADER_WORDS]
    count = hdr[0:2].view(torch.int32)[0]  # (lo, hi) on a little-endian host
    has_ts = hdr[2] > 0
    rel = hdr[4:36].view(torch.float32).reshape(4, 4)
    body = packed[HEADER_WORDS:]
    if codec == "f32":
        pts = body[:6 * bucket].view(torch.float32).reshape(bucket, 3)
        ts = body[6 * bucket:8 * bucket].view(torch.float32)
    else:
        offset = hdr[36:42].view(torch.float32)
        scale = hdr[42:48].view(torch.float32)
        q = _u16(body[:3 * bucket]).reshape(bucket, 3).to(torch.float32)
        # two roundings, where XLA may fuse JAX's into one multiply-add
        pts = offset[None, :] + q * scale[None, :]
        ts = (_u16(body[3 * bucket:4 * bucket]).to(torch.float32)
              * (1.0 / 65535.0))
    mask = torch.arange(bucket, dtype=torch.int32,
                        device=packed.device) < count
    if return_active:
        active = hdr[3] > 0
        # identity rel for inactive (all-zero) padding buffers: their rel
        # words decode to a zero matrix, which would poison the pose
        # composition even with the state update masked
        rel = torch.where(active, rel,
                          torch.eye(4, dtype=rel.dtype, device=rel.device))
        return pts, ts, mask, has_ts, rel, active
    return pts, ts, mask, has_ts, rel
