"""Voxel-grid utilities: point->voxel coords, the KISS-ICP spatial hash (the
map sharding's ownership rule) and first-point downsampling.

Equivalent of ``kiss_icp::VoxelDownsample`` (KISS-ICP v1.2.0): "keep the
first point per voxel" becomes a stable sort + run-head compaction under
static shapes, bit-equal to the JAX package's.  torch has no unsigned
32-bit shifts or minima, so every u32 word of the JAX version lives here as
an int64 holding the same value (0 .. 2^32 - 1); JAX's multi-operand sorts
become one composed int64 key (or successive stable sorts), which keeps
"first point wins".

Every function takes a leading batch axis: (B, N) planes are B independent
frames, each sorted, rebased and truncated on its own row (sorts along the
last axis, per-row minima), which is what ``jax.vmap`` of the JAX version
computes.  The batch index is never folded into the packed keys: they
already use the whole int64.
"""

from __future__ import annotations

import torch

from .points import P3

#: sentinel voxel coordinate for invalid/padded points (sorts last)
SENTINEL = 2**31 - 1
#: packed relative-coordinate sentinel (all-ones u32, sorts last)
PACKED_KEY_SENTINEL = 0xFFFFFFFF
#: width at which the packed-word (quantized-payload) downsample engages
PACKED_WORD_MIN_N = 32768

# KISS-ICP spatial hash constants (VoxelHashMap.cpp, v1.2.0)
_HX = 73856093
_HY = 19349669
_HZ = 83492791
_U32 = 0xFFFFFFFF


def voxel_coords_planar(p: P3, voxel_size: float):
    """floor(p / voxel_size) planes as int32, per KISS-ICP PointToVoxel."""
    inv = 1.0 / voxel_size
    return (torch.floor(p.x * inv).to(torch.int32),
            torch.floor(p.y * inv).to(torch.int32),
            torch.floor(p.z * inv).to(torch.int32))


def voxel_coords(points, voxel_size: float):
    """(..., 3) array form of ``voxel_coords_planar``."""
    return torch.floor(points / voxel_size).to(torch.int32)


def spatial_hash_planar(bx, by, bz):
    """Voxel coord planes -> (...,) u32 hash (KISS-ICP constants), as int64.

    Each u32 product is an int64 product masked to 32 bits: its low 32 bits
    are those of the u32 product, negative coordinates included."""
    return (((bx.to(torch.int64) * _HX) ^ (by.to(torch.int64) * _HY)
             ^ (bz.to(torch.int64) * _HZ)) & _U32)


def spatial_hash(coords):
    """(..., 3) int32 voxel coords -> (...,) u32 hash, as int64."""
    return spatial_hash_planar(coords[..., 0], coords[..., 1], coords[..., 2])


def lexsort(keys):
    """Stable lexicographic sort order along the last axis; ``keys`` most
    significant first.

    Successive stable sorts from the least significant key: equal keys keep
    input order, as ``jax.lax.sort(..., is_stable=True)`` does.
    """
    order = torch.sort(keys[-1], dim=-1, stable=True).indices
    for k in reversed(keys[:-1]):
        order = order.gather(-1, torch.sort(k.gather(-1, order), dim=-1,
                                            stable=True).indices)
    return order


def roll_heads(key):
    """``key != roll(key, 1)`` along the last axis with the first element
    of each row forced to a head."""
    head = key != torch.roll(key, 1, dims=-1)
    # fill_ with a Python value: an assignment would copy a host tensor,
    # which a CUDA graph capture refuses
    head[..., 0].fill_(True)
    return head


def rebase_minima(cx, cy, cz, mask):
    """Per-row minima of the valid voxel coords, each (..., 1)."""
    big = 1 << 30
    return tuple(torch.where(mask, c, big).amin(-1, keepdim=True)
                 for c in (cx, cy, cz))


def pack_rebased_keys(cx, cy, cz, mask):
    """Voxel coord planes -> one u32 key (10 bits per axis, rebased to the
    frame's per-axis minimum), as int64; invalid points get the sentinel."""
    mx, my, mz = rebase_minima(cx, cy, cz, mask)
    rx, ry, rz = cx - mx, cy - my, cz - mz
    # A point past the static extent bound drops for this frame instead of
    # corrupting the bit-packed grouping.
    mask = mask & (rx < 1024) & (ry < 1024) & (rz < 1024)
    key = (rx.to(torch.int64) << 20) | (ry.to(torch.int64) << 10) \
        | rz.to(torch.int64)
    return torch.where(mask, key, PACKED_KEY_SENTINEL)


def packable_span(voxel_size: float, max_extent: float | None) -> bool:
    """Static check: does a frame's coord span fit 10 bits per axis?"""
    if max_extent is None:
        return False
    return max_extent / voxel_size + 8 < 1024


def _packed_downsample_core(p: P3, mask, voxel_size: float,
                            tiebreak: str = "first"):
    """Grouping + compaction of the packed-word path.

    Returns (fkey (..., N), fword (..., N), (mnx, mny, mnz) each (..., 1),
    num_heads (...)): the first ``num_heads`` of each row are its surviving
    voxels in voxel-lex order.
    """
    cx, cy, cz = voxel_coords_planar(p, voxel_size)
    inv = 1.0 / voxel_size
    key = pack_rebased_keys(cx, cy, cz, mask)
    wx = torch.clamp((p.x * inv - cx) * 1024.0, 0, 1023).to(torch.int64)
    wy = torch.clamp((p.y * inv - cy) * 1024.0, 0, 1023).to(torch.int64)
    wz = torch.clamp((p.z * inv - cz) * 1024.0, 0, 1023).to(torch.int64)
    word = torch.where(mask, (wx << 20) | (wy << 10) | wz, 0)
    if tiebreak == "first":
        # stable on the key alone = (key, input index)
        order = torch.sort(key, dim=-1, stable=True).indices
    elif tiebreak == "min":
        # representative = smallest quantized offset; word < 2^30
        order = torch.sort((key << 30) | word, dim=-1, stable=True).indices
    else:
        raise ValueError(f"tiebreak {tiebreak!r}")
    key, word = key.gather(-1, order), word.gather(-1, order)
    valid = key != PACKED_KEY_SENTINEL
    head = roll_heads(key) & valid
    key2 = torch.where(head, key, PACKED_KEY_SENTINEL)
    order = torch.sort(key2, dim=-1, stable=True).indices
    return (key2.gather(-1, order), word.gather(-1, order),
            rebase_minima(cx, cy, cz, mask), head.sum(-1))


def _reconstruct_packed(fkey, fword, mins, voxel_size: float):
    """(key, word) rows -> P3 world points at bin centres."""
    half = 0.5 / 1024.0

    def rec(shift, mn):
        c = ((fkey >> shift) & 1023).to(torch.int32) + mn
        o = ((fword >> shift) & 1023).to(torch.float32)
        return (c.to(torch.float32) + o * (1.0 / 1024.0) + half) * voxel_size

    return P3(rec(20, mins[0]), rec(10, mins[1]), rec(0, mins[2]))


def _truncate(planes: P3, n: int, out_size: int):
    """The first ``out_size`` of each row, zero-padded past ``n``."""
    if out_size <= n:
        return P3(planes.x[..., :out_size], planes.y[..., :out_size],
                  planes.z[..., :out_size])
    pad = out_size - n
    return P3(*(torch.cat([a, a.new_zeros(a.shape[:-1] + (pad,))], dim=-1)
                for a in (planes.x, planes.y, planes.z)))


def voxel_downsample(p: P3, mask, voxel_size: float, out_size: int,
                     max_extent: float | None = None,
                     tiebreak: str = "first"):
    """Keep the first (in input order) point of each occupied voxel.

    Returns (P3 of (..., out_size), out_mask (..., out_size), num_dropped
    (...) int32): output in voxel-lexicographic order; voxels past
    ``out_size`` are dropped and counted, row by row.  At widths >=
    ``PACKED_WORD_MIN_N`` with a packable span the payload is one
    10/10/10-bit in-voxel word and survivors are reconstructed at bin
    centres (at most voxel_size/2048 per axis off).
    """
    cx, cy, cz = voxel_coords_planar(p, voxel_size)
    n = cx.shape[-1]

    if packable_span(voxel_size, max_extent) and n >= PACKED_WORD_MIN_N:
        fkey, fword, mins, num_heads = _packed_downsample_core(
            p, mask, voxel_size, tiebreak=tiebreak)
        out = _truncate(_reconstruct_packed(fkey, fword, mins, voxel_size),
                        n, out_size)
    else:
        if packable_span(voxel_size, max_extent):
            key = pack_rebased_keys(cx, cy, cz, mask)
            order = torch.sort(key, dim=-1, stable=True).indices
            key = key.gather(-1, order)
            valid = key != PACKED_KEY_SENTINEL
            head = roll_heads(key)
        else:
            cx = torch.where(mask, cx, SENTINEL)
            cy = torch.where(mask, cy, SENTINEL)
            cz = torch.where(mask, cz, SENTINEL)
            order = lexsort([cx, cy, cz])
            cx, cy, cz = (c.gather(-1, order) for c in (cx, cy, cz))
            valid = cx != SENTINEL
            head = roll_heads(cx) | roll_heads(cy) | roll_heads(cz)
        head = head & valid
        # Compact heads to the front; the key is the sorted position for
        # heads (unique), so head order is kept.
        pos = torch.where(head, torch.arange(n, dtype=torch.int32,
                                             device=head.device), n)
        order = order.gather(-1, torch.sort(pos, dim=-1, stable=True).indices)
        out = _truncate(p.take(order), n, out_size)
        num_heads = head.sum(-1)
    num_kept = torch.clamp(num_heads, max=out_size)
    out_mask = (torch.arange(out_size, device=num_kept.device)
                < num_kept[..., None])
    return out, out_mask, (num_heads - num_kept).to(torch.int32)


def double_downsample(p: P3, mask, voxel_size: float, *,
                      max_downsampled: int, max_source: int,
                      max_extent: float | None = None,
                      tiebreak: str = "first"):
    """KISS-ICP's double downsample (reference KinematicICP.cpp:38-44).

    Returns (source, source_mask, frame_downsample, frame_downsample_mask,
    dropped (..., 2) int32 = [frame_downsample, source] capacity
    overflows).
    """
    frame_ds, frame_ds_mask, drop_ds = voxel_downsample(
        p, mask, voxel_size * 0.5, max_downsampled, max_extent=max_extent,
        tiebreak=tiebreak)
    source, source_mask, drop_src = voxel_downsample(
        frame_ds, frame_ds_mask, voxel_size * 1.5, max_source,
        max_extent=max_extent)
    return (source, source_mask, frame_ds, frame_ds_mask,
            torch.stack([drop_ds, drop_src], dim=-1))
