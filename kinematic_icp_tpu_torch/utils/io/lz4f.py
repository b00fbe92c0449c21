"""Pure-Python LZ4 frame/block codec (decompression-complete, minimal
compressor) for hosts without the ``lz4`` module.

Covers what rosbag2-written MCAP files need (RosbagUtils.cpp reads bags via
rosbag2_storage, which offers lz4 chunk compression): the LZ4 frame format
(magic 0x184D2204, frame descriptor with optional content-size, data blocks
with the uncompressed-bit size prefix) and the LZ4 block sequence format.
Hash/checksum fields (xxHash32) are skipped, not verified — the MCAP layer
carries its own CRCs.

The compressor emits valid *literals-only* blocks (no back-references) so
round-trip tests exercise the real decoder; ratio is irrelevant for tests.
Speed: ~MB/s-class pure Python — fine for fixtures and occasional bags;
use zstd-compressed bags for production-scale ingestion.
"""

from __future__ import annotations

import struct

FRAME_MAGIC = 0x184D2204


def decompress_block(src: bytes, max_size: int | None = None,
                     out: bytearray | None = None,
                     history_base: int | None = None) -> bytes:
    """Decode one raw LZ4 block (sequence format).

    ``out``: optional shared output buffer — for block-LINKED frames
    (liblz4's LZ4F default, which rosbag2/mcap writers use) match offsets
    may reach back into previously decoded blocks, so the frame decoder
    passes its accumulated output here.  ``history_base`` is the lowest
    index a match may reference: 0 for linked blocks, the block's own
    start for independent blocks.  Returns the decoded bytes for
    standalone (fresh-buffer) calls; shared-buffer callers read ``out``
    directly and get ``b""`` back (skipping a per-block copy).
    """
    caller_owns_out = out is not None
    if out is None:
        out = bytearray()
    block_start = len(out)
    if history_base is None:
        history_base = block_start
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                b = src[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        out += src[i:i + lit_len]
        i += lit_len
        if i >= n:
            break  # last sequence has no match
        offset = struct.unpack_from("<H", src, i)[0]
        i += 2
        if offset == 0:
            raise ValueError("corrupt LZ4 block: zero match offset")
        match_len = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                match_len += b
                if b != 255:
                    break
        start = len(out) - offset
        if start < history_base:
            raise ValueError("corrupt LZ4 block: offset before history")
        for _ in range(match_len):  # may self-overlap; byte-wise copy
            out.append(out[start])
            start += 1
        if max_size is not None and len(out) - block_start > max_size:
            raise ValueError("LZ4 block exceeds declared size")
    # The frame decoder reads the shared buffer directly; copying the
    # block's bytes out matters only for standalone (fresh-buffer) calls.
    return b"" if caller_owns_out else bytes(out)


def compress_block(data: bytes) -> bytes:
    """Encode ``data`` as a literals-only LZ4 block (valid, ratio 1.0x)."""
    out = bytearray()
    lit_len = len(data)
    token_lit = min(lit_len, 15)
    out.append(token_lit << 4)
    if token_lit == 15:
        rest = lit_len - 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)
    out += data
    return bytes(out)


def decompress_frame(src: bytes) -> bytes:
    """Decode an LZ4 frame (possibly several concatenated)."""
    out = bytearray()
    i = 0
    while i + 4 <= len(src):
        magic = struct.unpack_from("<I", src, i)[0]
        i += 4
        if magic != FRAME_MAGIC:
            raise ValueError(f"not an LZ4 frame (magic {magic:#x})")
        flg = src[i]
        bd = src[i + 1]
        del bd  # block max size — irrelevant for decoding
        i += 2
        version = flg >> 6
        if version != 1:
            raise ValueError(f"unsupported LZ4 frame version {version}")
        block_indep = (flg >> 5) & 1
        block_checksum = (flg >> 4) & 1
        content_size = (flg >> 3) & 1
        content_checksum = (flg >> 2) & 1
        dict_id = flg & 1
        if content_size:
            i += 8
        if dict_id:
            i += 4
        i += 1  # header checksum byte
        frame_start = len(out)
        while True:
            bsize = struct.unpack_from("<I", src, i)[0]
            i += 4
            if bsize == 0:  # EndMark
                break
            uncompressed = bsize & 0x80000000
            bsize &= 0x7FFFFFFF
            payload = src[i:i + bsize]
            i += bsize
            if uncompressed:
                out += payload
            else:
                # Block-linked frames (liblz4's LZ4F default, what
                # rosbag2/mcap writers emit) let matches reach back into
                # earlier blocks of the same frame; independent blocks
                # are confined to their own start.
                decompress_block(
                    payload, out=out,
                    history_base=len(out) if block_indep else frame_start)
            if block_checksum:
                i += 4
        if content_checksum:
            i += 4
    return bytes(out)


def compress_frame(data: bytes) -> bytes:
    """Encode one LZ4 frame of literals-only compressed blocks."""
    flg = (1 << 6) | (1 << 5)  # version 1, independent blocks
    bd = 7 << 4                # 4 MB block max size
    header = struct.pack("<BB", flg, bd)
    # header checksum: (xxh32(descriptor) >> 8) & 0xFF — we emit the real
    # xxHash32 so strict readers accept the frame.
    hc = (_xxh32(header) >> 8) & 0xFF
    out = bytearray(struct.pack("<I", FRAME_MAGIC) + header + bytes([hc]))
    block = compress_block(data)
    if len(block) >= len(data) + 1:
        out += struct.pack("<I", 0x80000000 | len(data)) + data
    else:
        out += struct.pack("<I", len(block)) + block
    out += struct.pack("<I", 0)  # EndMark
    return bytes(out)


# ----------------------------------------------------------------------
# xxHash32 (for the frame header checksum only)
# ----------------------------------------------------------------------
_P1, _P2, _P3, _P4, _P5 = (2654435761, 2246822519, 3266489917,
                           668265263, 374761393)
_M = 0xFFFFFFFF


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M


def _xxh32(data: bytes, seed: int = 0) -> int:
    i, n = 0, len(data)
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M
        v2 = (seed + _P2) & _M
        v3 = seed
        v4 = (seed - _P1) & _M
        while i + 16 <= n:
            for k, v in enumerate((v1, v2, v3, v4)):
                lane = struct.unpack_from("<I", data, i + 4 * k)[0]
                v = (v + lane * _P2) & _M
                v = _rotl(v, 13)
                v = (v * _P1) & _M
                if k == 0:
                    v1 = v
                elif k == 1:
                    v2 = v
                elif k == 2:
                    v3 = v
                else:
                    v4 = v
            i += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while i + 4 <= n:
        h = (h + struct.unpack_from("<I", data, i)[0] * _P3) & _M
        h = (_rotl(h, 17) * _P4) & _M
        i += 4
    while i < n:
        h = (h + data[i] * _P5) & _M
        h = (_rotl(h, 11) * _P1) & _M
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M
    h ^= h >> 13
    h = (h * _P3) & _M
    h ^= h >> 16
    return h
