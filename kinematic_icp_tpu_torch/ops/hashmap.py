"""Device-resident sparse voxel hash map (the local map), bucket-table form.

Equivalent of ``kiss_icp::VoxelHashMap`` (KISS-ICP v1.2.0) with the JAX
package's layout, bit for bit:

    table: (NB, G*R) int32, NB buckets, R = K + 4 lanes per voxel slot,
      G slots a bucket
      lanes [0..K-1] : packed points, 10/10/10-bit in-voxel offsets;
                       0xFFFFFFFF (int32 -1) = unused entry
      lane  [K]      : key fingerprint (0 = empty slot)
      lanes [K+1..]  : exact voxel key (kx, ky, kz)

A batch of B sequences' maps is one (B, NB, G*R) table beside (B, N)
query planes; every operation works on each sequence's rows alone, as
``jax.vmap`` of the JAX version does.  Row gathers and the insert scatter
index the flattened (B*NB, G*R) table at ``b*NB + bucket``.

The table holds the u32 words of the JAX version as int32 bits, so
``table.view(uint32)`` in numpy compares bit for bit.  Hashes are computed
in int64 masked to 32 bits (torch has no u32 shifts or adds); an int64
product of two values below 2^32 wraps, but its low 32 bits are right.

Writes are functional: ``insert`` and ``evict_far`` return a new table.
JAX's dropped scatters become one ``index_put_`` on a copy with one spare
trailing element, the sink every masked row of every sequence writes to,
so no index is ever out of range.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import nn27
from .points import P3, per_row, transform
from .voxel import (PACKED_KEY_SENTINEL, SENTINEL, lexsort, pack_rebased_keys,
                    packable_span, rebase_minima, roll_heads,
                    voxel_coords_planar)

#: packed-point sentinel (u32 all-ones) as int32 bits
PACKED_SENTINEL = -1
#: offset quantization steps per voxel edge (10 bits)
_QUANT = 1024
#: extra lanes per slot: fingerprint + 3 exact key components
_META_LANES = 4
_U32 = 0xFFFFFFFF

_F1, _F2, _F3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D


@dataclasses.dataclass(frozen=True)
class MapState:
    table: torch.Tensor  # (NB, G * (K + 4)) int32; (B, NB, ...) batched
    bucket_slots: int

    @property
    def num_buckets(self):
        return self.table.shape[-2]

    @property
    def capacity(self):
        return self.num_buckets * self.bucket_slots

    @property
    def block_size(self):
        return self.table.shape[-1] // self.bucket_slots - _META_LANES


class CandidateSet(NamedTuple):
    """Candidate map points per query, packed, query axis last.

    ``words`` (V, K, N) int32 bits of the stored offsets (-1 = none);
    ``rel`` (V, N) int32 in [0, 27): which neighbour offset each row probes
    relative to ``base_*``, the query's voxel coords at gather time (N,).
    A batch puts B before each: (B, V, K, N), (B, V, N), (B, N).
    """
    words: torch.Tensor
    rel: torch.Tensor
    base_x: torch.Tensor
    base_y: torch.Tensor
    base_z: torch.Tensor


def _u32(x):
    """int tensor -> int64 holding its u32 bit pattern."""
    return x.to(torch.int64) & _U32


def _i32(h):
    """int64 holding a u32 value -> int32 with the same bits."""
    return torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)


def fingerprint(bx, by, bz):
    """Second hash with the high bit forced (0 never collides with empty);
    int32 bits."""
    h = (_u32(bx) * _F1 + _u32(by) * _F2 + _u32(bz) * _F3) & _U32
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _U32
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & _U32
    h = h ^ (h >> 16)
    return _i32(h | 0x80000000)


def bucket_of(bx, by, bz, num_buckets: int):
    """Bucket row index of a voxel (additive combine + murmur finalizer)."""
    h = (_u32(bx) * 0x85297A4D + _u32(by) * 0x68E31DA4
         + _u32(bz) * 0xB5297A4D) & _U32
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B3) & _U32
    h = h ^ (h >> 15)
    return (h & (num_buckets - 1)).to(torch.int32)


def empty(capacity: int, max_points_per_voxel: int, bucket_slots: int = 4,
          device=None) -> MapState:
    if capacity % bucket_slots:
        raise ValueError("capacity must be a multiple of bucket_slots")
    b = capacity // bucket_slots
    if b & (b - 1):
        raise ValueError("bucket count must be a power of two")
    r = max_points_per_voxel + _META_LANES
    row = torch.zeros((bucket_slots, r), dtype=torch.int32, device=device)
    row[:, :max_points_per_voxel] = PACKED_SENTINEL
    return MapState(table=row.reshape(1, -1).repeat(b, 1),
                    bucket_slots=bucket_slots)


def clear(m: MapState) -> MapState:
    return empty(m.capacity, m.block_size, bucket_slots=m.bucket_slots,
                 device=m.table.device)


def _slots(m: MapState):
    """(..., NB, G, R) view of the table."""
    return m.table.view(*m.table.shape[:-1], m.bucket_slots, -1)


def _flat_rows(m: MapState, bucket):
    """Row indices (int64) into the flattened (B*NB, G*R) table of
    per-sequence bucket indices: ``b*NB + bucket`` in a batch."""
    bucket = bucket.long()
    if m.table.dim() == 3:
        first = torch.arange(m.table.shape[0], device=bucket.device)
        bucket = bucket + (first * m.num_buckets).view(
            -1, *([1] * (bucket.dim() - 1)))
    return bucket


def _rows(m: MapState, flat_rows):
    """The fat bucket rows (..., G*R) at ``_flat_rows`` indices."""
    return m.table.reshape(-1, m.table.shape[-1])[flat_rows]


def num_voxels(m: MapState):
    """Occupied voxel slots (of each sequence, in a batch)."""
    return (_slots(m)[..., m.block_size] != 0).sum((-2, -1))


def is_empty(m: MapState):
    return num_voxels(m) == 0


def slot_counts(m: MapState):
    """(NB, G) stored-point count per voxel slot (blocks fill
    contiguously)."""
    s = _slots(m)
    k = m.block_size
    stored = (s[..., :k] != PACKED_SENTINEL).sum(-1, dtype=torch.int32)
    return torch.where(s[..., k] != 0, stored, 0)


def pack_offsets(p: P3, bx, by, bz, voxel_size: float):
    """World points -> packed 10/10/10-bit in-voxel offsets (int32)."""
    inv = _QUANT / voxel_size

    def q(c, b):
        return torch.clamp((c - b * voxel_size) * inv, 0,
                           _QUANT - 1).to(torch.int32)

    return q(p.x, bx) | (q(p.y, by) << 10) | (q(p.z, bz) << 20)


def unpack_offsets(words, bx, by, bz, voxel_size: float,
                   dtype=torch.float32):
    """Packed words + voxel coords -> world coordinates (quantization-cell
    centres).  int32 ``>>`` is arithmetic, but every field is masked to its
    10 bits, which come from the word alone."""
    step = voxel_size / _QUANT
    ox = (words & (_QUANT - 1)).to(dtype)
    oy = ((words >> 10) & (_QUANT - 1)).to(dtype)
    oz = ((words >> 20) & (_QUANT - 1)).to(dtype)
    half = 0.5
    return P3(bx.to(dtype) * voxel_size + (ox + half) * step,
              by.to(dtype) * voxel_size + (oy + half) * step,
              bz.to(dtype) * voxel_size + (oz + half) * step)


def pointcloud(m: MapState, voxel_size: float):
    """All stored world points + validity mask (LocalMap()/Pointcloud()
    parity), slot-major as in the JAX version.  Returns (P3 of (C*K,),
    mask (C*K,))."""
    k = m.block_size
    s = _slots(m).transpose(0, 1)                                # (G, B, R)
    words = s[..., :k].reshape(-1)

    def per_point(lane):
        return s[..., lane].repeat_interleave(k, dim=-1).reshape(-1)

    mask = (words != PACKED_SENTINEL) & (per_point(k) != 0)
    pts = unpack_offsets(words, per_point(k + 1), per_point(k + 2),
                         per_point(k + 3), voxel_size)
    return pts, mask


def _box_lower_bound_d2(q: P3, bx, by, bz, voxel_size: float):
    """Squared distance from each query (..., N) to each voxel box
    (..., 27, N)."""
    def axis(b, c):
        lo = b.to(c.dtype) * voxel_size
        c = c[..., None, :]
        return torch.clamp(torch.maximum(lo - c, c - (lo + voxel_size)),
                           min=0.0)

    dx, dy, dz = axis(bx, q.x), axis(by, q.y), axis(bz, q.z)
    return dx * dx + dy * dy + dz * dz


def _rel_to_offsets(rel):
    """Neighbour-offset id in [0, 27) -> (ox, oy, oz) in {-1, 0, 1}."""
    return rel // 9 - 1, (rel // 3) % 3 - 1, rel % 3 - 1


def _voxel_words(m: MapState, bx, by, bz):
    """The packed words stored in voxels (bx, by, bz), each (..., V, N):
    (..., V, N, K) int32, -1 where the voxel is absent.  One row gather of
    the fat bucket rows; a voxel occupies at most one slot of its bucket."""
    k, g = m.block_size, m.bucket_slots
    rows = _flat_rows(m, bucket_of(bx, by, bz, m.num_buckets))
    fat = _rows(m, rows).view(*bx.shape, g,
                              k + _META_LANES)         # (..., V, N, G, R)
    hit = ((fat[..., k] == fingerprint(bx, by, bz)[..., None])
           & (fat[..., k + 1] == bx[..., None])
           & (fat[..., k + 2] == by[..., None])
           & (fat[..., k + 3] == bz[..., None]))                # (V, N, G)
    words = torch.full((*bx.shape, k), PACKED_SENTINEL, dtype=torch.int32,
                       device=bx.device)
    for gi in range(g):
        words = torch.where(hit[..., gi, None], fat[..., gi, :k], words)
    return words


def gather_candidates(m: MapState, q: P3, voxel_size: float, max_probes: int,
                      num_candidate_voxels: int = 27,
                      return_skip_bound: bool = False):
    """One gather pass: candidate map points around each query.

    Per query, the ``num_candidate_voxels`` (V) voxels with the smallest
    point-to-box lower bound are fetched (V = 27 is the whole
    neighbourhood).  The offset id rides in the low 5 bits of the bitcast
    bound, so one sort over the 27-row axis ranks them.

    ``return_skip_bound`` also returns ``skip_lb_d2`` (N,) float32: per
    query, the smallest squared box bound among the 27 - V voxels NOT
    fetched (+inf when V = 27), the exactness certificate of pruned
    search.  Masking the 5 id bits rounds the bound down, never up.

    Batched: a (B, NB, G*R) table and (B, N) queries give (B, ...) words,
    rel and bases (and a (B, N) bound).
    """
    del max_probes  # the bucket holds every probe slot
    v = num_candidate_voxels
    dev = q.x.device
    base_x, base_y, base_z = voxel_coords_planar(q, voxel_size)

    ids = torch.arange(27, dtype=torch.int32, device=dev)[:, None]
    if v < 27:
        ox, oy, oz = _rel_to_offsets(ids)
        # the key packs float32 bits (a no-op cast for float32 queries)
        lb = _box_lower_bound_d2(q, base_x[..., None, :] + ox,
                                 base_y[..., None, :] + oy,
                                 base_z[..., None, :] + oz, voxel_size
                                 ).to(torch.float32)        # (..., 27, N)
        key = (_u32(lb.view(torch.int32)) & 0xFFFFFFE0) | ids
        key = torch.sort(key, dim=-2).values
        if return_skip_bound:
            # row v is the nearest skipped box (keys sort ascending)
            skip_lb_d2 = _i32(key[..., v, :] & 0xFFFFFFE0).view(
                torch.float32)
        rel = (key[..., :v, :] & 31).to(torch.int32)
    else:
        if return_skip_bound:
            skip_lb_d2 = torch.full(q.x.shape, torch.inf,
                                    dtype=torch.float32, device=dev)
        rel = ids.expand(*q.x.shape[:-1], 27, q.x.shape[-1])
    ox, oy, oz = _rel_to_offsets(rel)
    words = _voxel_words(m, base_x[..., None, :] + ox,
                         base_y[..., None, :] + oy,
                         base_z[..., None, :] + oz)
    cand = CandidateSet(words=words.transpose(-1, -2).contiguous(),
                        rel=rel.contiguous(), base_x=base_x,
                        base_y=base_y, base_z=base_z)
    if return_skip_bound:
        return cand, skip_lb_d2
    return cand


def _candidate_points(cand: CandidateSet, voxel_size: float,
                      dtype=torch.float32):
    """Unpack candidate words -> ((..., V, K, N) coordinate planes,
    valid)."""
    ox, oy, oz = _rel_to_offsets(cand.rel[..., None, :])
    pts = unpack_offsets(cand.words,
                         cand.base_x[..., None, None, :] + ox,
                         cand.base_y[..., None, None, :] + oy,
                         cand.base_z[..., None, None, :] + oz,
                         voxel_size, dtype)
    return pts, cand.words != PACKED_SENTINEL


def reduce_candidates(cand: CandidateSet, q: P3, keep: int,
                      voxel_size: float) -> CandidateSet:
    """Shrink each voxel's candidate list to its ``keep`` nearest points,
    ranked at the query positions ``q`` (the initial guess); ties go to
    the lowest entry lane (Config.gn_candidates_per_voxel)."""
    k = cand.words.shape[-2]
    if keep >= k:
        return cand
    pts, valid = _candidate_points(cand, voxel_size, q.x.dtype)
    dx = pts.x - q.x[..., None, None, :]
    dy = pts.y - q.y[..., None, None, :]
    dz = pts.z - q.z[..., None, None, :]
    cur = torch.where(valid, dx * dx + dy * dy + dz * dz, torch.inf)
    lane = torch.arange(k, device=q.x.device)[:, None]
    outs = []
    for _ in range(keep):
        best = cur.amin(dim=-2, keepdim=True)
        first = torch.where(cur == best, lane, k).amin(dim=-2, keepdim=True)
        pick = lane == first                      # one lane per (v, n)
        word = torch.where(pick, cand.words, 0).sum(dim=-2,
                                                    dtype=torch.int32)
        outs.append(torch.where(torch.isfinite(best[..., 0, :]), word,
                                PACKED_SENTINEL))
        cur = torch.where(pick, torch.inf, cur)
    return cand._replace(words=torch.stack(outs, dim=-2))


def nn_from_candidates(cand: CandidateSet, q: P3, query_mask,
                       voxel_size: float):
    """Closest candidate per query.

    The min-reduced key is the bitcast squared distance with its low 10
    mantissa bits replaced by (offset id, entry lane), so ties break to the
    lowest (offset id, lane) and the key alone rebuilds the winner.
    Returns (P3 neighbours (N,), dist (N,)); inf distance when none.  A
    batch gives (B, N) of each.
    """
    k = cand.words.shape[-2]
    if k > 32:
        raise ValueError("packed argmin key holds a 5-bit entry lane")
    pts, valid = _candidate_points(cand, voxel_size, q.x.dtype)
    dx = pts.x - q.x[..., None, None, :]
    dy = pts.y - q.y[..., None, None, :]
    dz = pts.z - q.z[..., None, None, :]
    d2 = dx * dx + dy * dy + dz * dz

    lane = torch.arange(k, dtype=torch.int64, device=q.x.device)[:, None]
    tag = (cand.rel.to(torch.int64)[..., None, :] << 5) | lane
    # the key packs float32 bits (a no-op cast for float32 queries)
    key = (_u32(d2.to(torch.float32).view(torch.int32)) & ~0x3FF) | tag
    key = torch.where(valid & query_mask[..., None, None, :], key, _U32)
    best = key.amin(dim=(-3, -2))                                # (..., N)

    # (rel, lane) is unique per query; a query with no candidate sums the
    # sentinel words, wrapping like the u32 sum of the JAX version.
    pick = key == best[..., None, None, :]
    word = torch.where(pick, _u32(cand.words), 0).sum(dim=(-3, -2)) & _U32
    wx, wy, wz = _rel_to_offsets(((best >> 5) & 31).to(torch.int32))
    nearest = unpack_offsets(_i32(word), cand.base_x + wx, cand.base_y + wy,
                             cand.base_z + wz, voxel_size, q.x.dtype)
    ex = nearest.x - q.x
    ey = nearest.y - q.y
    ez = nearest.z - q.z
    has = best != _U32
    dist = torch.where(query_mask & has, torch.sqrt(ex * ex + ey * ey + ez * ez),
                       torch.inf)
    return nearest, dist


def nearest_neighbor(m: MapState, q: P3, query_mask, voxel_size: float,
                     max_probes: int, num_candidate_voxels: int = 27):
    """Batched GetClosestNeighbor over the (possibly pruned) neighbourhood.

    At V = 27 this is the selection of the JAX package's
    ``nearest_neighbor_native`` bit for bit: that function exists there to
    steer XLA's layout assignment, which eager PyTorch does not have.

    Where ``nn27.applies`` (CUDA tensors, V = 27) the search is one launch
    of ``csrc/nn27.cu`` with the same bits on every live query; otherwise
    it is the plain version below, the kernel's oracle.
    """
    if nn27.applies(m.table, q, num_candidate_voxels):
        return nn27.nearest_neighbor(m, q, query_mask, voxel_size)
    cand = gather_candidates(m, q, voxel_size, max_probes, num_candidate_voxels)
    return nn_from_candidates(cand, q, query_mask, voxel_size)


def insert(m: MapState, p: P3, mask, voxel_size: float, max_probes: int,
           max_extent: float | None = None, return_failed: bool = False):
    """AddPoints: insert world-frame points, first-come-kept per voxel block.

    Points are grouped by (bucket, voxel) with one stable sort, so input
    order inside a voxel is kept (``VoxelBlock::AddPoint``).  New voxel #j
    of a bucket run takes the j-th currently empty slot of that bucket;
    new voxels past the empty slots fail this frame and are counted
    (``return_failed``) — they retry on later frames.

    Batched ((B, NB, G*R) table, (B, N) points and mask): each sequence's
    points are sorted, ranked and scattered into its own rows; the failure
    count is (B,).
    """
    del max_probes
    g = m.bucket_slots
    kmax = m.block_size
    r = kmax + _META_LANES
    n = p.x.shape[-1]
    dev = p.x.device
    cx, cy, cz = voxel_coords_planar(p, voxel_size)

    if packable_span(voxel_size, max_extent):
        mnx, mny, mnz = rebase_minima(cx, cy, cz, mask)
        vkey = pack_rebased_keys(cx, cy, cz, mask)
        bucket_key = bucket_of(cx, cy, cz, m.num_buckets)
        order = torch.sort((bucket_key.to(torch.int64) << 32) | vkey,
                           dim=-1, stable=True).indices
        bucket_key, vkey = bucket_key.gather(-1, order), vkey.gather(-1, order)
        svalid = vkey != PACKED_KEY_SENTINEL
        cx = ((vkey >> 20) & 1023).to(torch.int32) + mnx
        cy = ((vkey >> 10) & 1023).to(torch.int32) + mny
        cz = (vkey & 1023).to(torch.int32) + mnz
        cx = torch.where(svalid, cx, SENTINEL)
        cy = torch.where(svalid, cy, SENTINEL)
        cz = torch.where(svalid, cz, SENTINEL)
        head = roll_heads(vkey) & svalid
    else:
        cx = torch.where(mask, cx, SENTINEL)
        cy = torch.where(mask, cy, SENTINEL)
        cz = torch.where(mask, cz, SENTINEL)
        bucket_key = bucket_of(cx, cy, cz, m.num_buckets)
        order = lexsort([bucket_key, cx, cy, cz])
        bucket_key = bucket_key.gather(-1, order)
        cx, cy, cz = (c.gather(-1, order) for c in (cx, cy, cz))
        svalid = cx != SENTINEL
        head = (roll_heads(cx) | roll_heads(cy) | roll_heads(cz)) & svalid
    sp = p.take(order)
    run_start = roll_heads(bucket_key)

    # --- probe: every point reads its bucket row --------------------------
    fpq = fingerprint(cx, cy, cz)
    bucket_row = _flat_rows(m, bucket_key)
    fat = _rows(m, bucket_row).view(*cx.shape, g, r)
    fills = (fat[..., :kmax] != PACKED_SENTINEL).sum(-1)     # (..., n, G)
    hit_g = ((fat[..., kmax] == fpq[..., None])
             & (fat[..., kmax + 1] == cx[..., None])
             & (fat[..., kmax + 2] == cy[..., None])
             & (fat[..., kmax + 3] == cz[..., None])
             & svalid[..., None])
    gsel = torch.arange(g, device=dev)
    found = hit_g.any(-1)
    found_slot = torch.where(hit_g, gsel, 0).sum(-1)
    base = torch.where(hit_g, fills, 0).sum(-1)
    win_empty = fat[..., kmax] == 0                          # (..., n, G)

    # --- segmented counters (along each sequence's points) ---------------
    iota = torch.arange(n, device=dev)
    pend_head = (head & ~found).to(torch.int64)
    pend_cum = torch.cumsum(pend_head, -1)
    run_base = torch.cummax(torch.where(run_start, pend_cum - pend_head, -1),
                            -1).values
    # rank of this point's new voxel among the new voxels of its bucket run
    pend_rank = pend_cum - run_base - 1
    head_pos = torch.cummax(torch.where(head, iota, -1), -1).values
    lane = iota - head_pos

    # --- slot assignment: new voxel #j takes the j-th empty slot ----------
    tgt = torch.full(cx.shape, g, dtype=torch.int64, device=dev)
    cnt = torch.zeros(cx.shape, dtype=torch.int64, device=dev)
    for pp in range(g):
        take = win_empty[..., pp] & (cnt == pend_rank) & (tgt == g)
        tgt = torch.where(take, pp, tgt)
        cnt = cnt + win_empty[..., pp]
    sub = torch.where(found, found_slot, tgt)
    has_slot = svalid & (found | (tgt < g))

    # --- one scatter: a word per stored point + meta lanes per new voxel ---
    row_lanes = g * r
    size = m.table.numel()  # the sink's index
    dest_k = base + lane
    ok = has_slot & (dest_k < kmax)
    words = pack_offsets(sp, cx, cy, cz, voxel_size)
    slot_base = bucket_row * row_lanes + torch.clamp(sub, max=g - 1) * r
    word_idx = torch.where(ok, slot_base + torch.clamp(dest_k, max=kmax - 1),
                           size)
    fresh = head & ~found & (tgt < g)
    meta_idx = torch.where(fresh[..., None],
                           slot_base[..., None] + kmax
                           + torch.arange(4, device=dev), size)
    meta = torch.stack((fpq, cx, cy, cz), dim=-1)
    flat = torch.cat((m.table.reshape(-1),
                      m.table.new_zeros(1)))                      # + sink
    flat.index_put_((torch.cat((word_idx.reshape(-1),
                                meta_idx.reshape(-1))),),
                    torch.cat((words.reshape(-1), meta.reshape(-1))))
    out = MapState(table=flat[:size].view(m.table.shape), bucket_slots=g)
    if return_failed:
        failed = (head & ~found & (tgt >= g)).sum(-1).to(torch.int32)
        return out, failed
    return out


def evict_far(m: MapState, origin, max_distance: float, voxel_size: float,
              enable=None) -> MapState:
    """RemovePointsFarFromLocation: drop blocks whose FIRST point is
    farther than ``max_distance`` (strict) from ``origin``; killed slots
    reset to the empty pattern.  ``enable`` (scalar bool) gates the whole
    eviction.  Batched: (B, 3) origins and a (B,) ``enable``, one per
    sequence's table."""
    k = m.block_size
    s = _slots(m)                                         # (..., NB, G, R)
    fpt = unpack_offsets(s[..., 0], s[..., k + 1], s[..., k + 2],
                         s[..., k + 3], voxel_size)
    ox, oy, oz = (per_row(origin[..., i], 2) for i in range(3))
    dx, dy, dz = fpt.x - ox, fpt.y - oy, fpt.z - oz
    d2 = dx * dx + dy * dy + dz * dz
    kill = (s[..., k] != 0) & (d2 > max_distance * max_distance)
    if enable is not None:
        kill = kill & per_row(enable, 2)
    lane = torch.arange(s.shape[-1], device=s.device)
    reset = torch.where(lane < k, PACKED_SENTINEL, 0).to(torch.int32)
    table = torch.where(kill[..., None], reset, s)
    return MapState(table=table.view(m.table.shape), bucket_slots=m.bucket_slots)


def update(m: MapState, p: P3, mask, pose, voxel_size: float,
           max_distance: float, max_probes: int, enable=None,
           max_extent: float | None = None, return_failed: bool = False):
    """VoxelHashMap::Update: transform by pose, insert, evict far blocks.

    ``enable`` False returns the map byte-identical (folded into the insert
    mask and the eviction kill mask).  Batched: (B, 4, 4) poses and a (B,)
    ``enable``.
    """
    world = transform(pose, p)
    if enable is not None:
        mask = mask & per_row(enable)
    m, failed = insert(m, world, mask, voxel_size, max_probes,
                       max_extent=max_extent, return_failed=True)
    m = evict_far(m, pose[..., :3, 3], max_distance, voxel_size,
                  enable=enable)
    if return_failed:
        return m, failed
    return m
