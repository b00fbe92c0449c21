"""Plain reference of Kinematic-ICP odometry, vectorised in PyTorch.

The reference algorithm (PRBonn/kinematic-icp: pipeline/KinematicICP.cpp,
registration/Registration.cpp, correspondence_threshold/
CorrespondenceThreshold.cpp) with the KISS-ICP v1.2.0 parts it uses
(Preprocessor, VoxelDownsample, VoxelHashMap), written from the reference
and from ``kinematic_icp_tpu_torch/oracle/reference.py`` (a per-point
float64 loop, too slow for whole drives) at commit
dc36a2491db637ba74eeae484c593953a0d99c15.  It imports nothing of the
program and keeps every map point exactly, in a sorted table of voxel
keys with a (voxels, max_points_per_voxel, 3) block of points.

The order in which KISS-ICP's ``robin_map`` iterates voxels is the hash
table's and is not specified; here a downsampled cloud comes out in
voxel-lexicographic order (x, then y, then z), the first point of each
voxel in input order, and map points are added in that order.

Association follows the configuration:

* ``"exact"``: the reference's own, the nearest of every map point in the
  27 voxels around the query, gathered again at every Gauss-Newton
  iteration (Registration.cpp:69-79, 179-187);
* ``"cached"`` with ``candidate_voxels`` V: at the initial guess each
  source point keeps the V of its 27 neighbour voxels whose boxes lie
  nearest to it, and every iteration takes the nearest point among those
  voxels' points (the configuration's candidate cache).

``precision`` "float64" is the reference.  "tf32" is the control that
the comparison has to fail: the same steps in float32 with every matrix
product's operands rounded to TF32 (10 explicit mantissa bits, rounded to
nearest even) before an exact float32 product, which is what the card's
TF32 products compute, on any device.
"""

from __future__ import annotations

import math

import torch

#: a frame moves the state only when |log(delta)| exceeds this
#: (LidarOdometryServer.cpp:202)
STATIONARY_GATE = 1e-3
_OFF = 1 << 20
_TINY = 2.2250738585072014e-308


def tf32(x):
    """float32 values rounded to TF32 (10 mantissa bits, to nearest even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def tf32_matmul(a, b):
    return torch.matmul(tf32(a), tf32(b))


PRECISIONS = {"float64": (torch.float64, torch.matmul),
              "tf32": (torch.float32, tf32_matmul)}


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def se3_exp(xi):
    """(..., 6) twists (v, w) -> (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    th = torch.linalg.vector_norm(w, dim=-1)[..., None, None]
    small = th < 1e-4
    t = torch.where(small, torch.ones_like(th), th)
    th2 = th * th
    a = torch.where(small, 1 - th2 / 6, torch.sin(t) / t)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(t)) / (t * t))
    c = torch.where(small, 1 / 6 - th2 / 120, (1 - torch.sin(t) / t) / (t * t))
    W = hat(w)
    WW = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + a * W + b * WW
    V = eye + b * W + c * WW
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ v[..., None])[..., 0]
    T[..., 3, 3] = 1
    return T


def rotation_angle(R):
    """Angle of (..., 3, 3) rotations, from both the sine and the cosine."""
    s = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                           R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    c = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1)
    return torch.atan2(torch.linalg.vector_norm(s, dim=-1), c), s


def se3_log(T):
    """(4, 4) -> (6,) twist (v, w)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    th, s = rotation_angle(R)
    sn = torch.linalg.vector_norm(s, dim=-1)
    if float(th) < 1e-8:
        w = s
    else:
        w = s * (th / sn)
    W = hat(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    if float(th) < 1e-4:
        vinv = eye - 0.5 * W + (W @ W) / 12
    else:
        a = math.sin(float(th)) / float(th)
        b = (1 - math.cos(float(th))) / float(th) ** 2
        vinv = eye - 0.5 * W + (1 - a / (2 * b)) / float(th) ** 2 * (W @ W)
    return torch.cat([vinv @ t, w])


def motion_model(dx):
    """Unicycle delta (rho, theta) -> (4, 4) (Registration.cpp:40-46)."""
    rho, th = dx[0], dx[1]
    xi = torch.zeros(6, dtype=dx.dtype, device=dx.device)
    xi[0] = rho * torch.sin(th) / (th + _TINY)
    xi[1] = rho * (1 - torch.cos(th)) / (th + _TINY)
    xi[5] = th
    return se3_exp(xi)


def voxel_of(p, size: float):
    return torch.floor(p / size).to(torch.int64)


def pack(c):
    """(..., 3) voxel coordinates -> int64 keys in x-major order."""
    c = c + _OFF
    return (c[..., 0] << 42) | (c[..., 1] << 21) | c[..., 2]


def downsample(p, size: float):
    """The first point (in input order) of every occupied voxel, in
    voxel-lexicographic order."""
    if len(p) == 0:
        return p
    key = pack(voxel_of(p, size))
    order = torch.sort(key, stable=True).indices
    k = key[order]
    head = torch.ones_like(k, dtype=torch.bool)
    head[1:] = k[1:] != k[:-1]
    return p[order[head]]


class VoxelMap:
    """KISS-ICP v1.2.0's VoxelHashMap: up to ``max_points`` points a
    voxel, first come kept; voxels whose first point lies farther than
    ``max_distance`` from the pose are dropped after each update."""

    def __init__(self, voxel_size, max_distance, max_points, dtype, device):
        self.voxel_size = voxel_size
        self.max_distance = max_distance
        self.max_points = max_points
        self.keys = torch.zeros(0, dtype=torch.int64, device=device)
        self.points = torch.zeros((0, max_points, 3), dtype=dtype,
                                  device=device)
        self.count = torch.zeros(0, dtype=torch.int64, device=device)

    def empty(self):
        return len(self.keys) == 0

    def find(self, keys):
        """Row of each key in the table, -1 where absent."""
        m = len(self.keys)
        if m == 0:
            return torch.full_like(keys, -1)
        idx = torch.searchsorted(self.keys, keys).clamp(max=m - 1)
        return torch.where(self.keys[idx] == keys, idx, -1)

    def add(self, world):
        if len(world) == 0:
            return
        key = pack(voxel_of(world, self.voxel_size))
        order = torch.sort(key, stable=True).indices
        key, world = key[order], world[order]
        n = len(key)
        head = torch.ones(n, dtype=torch.bool, device=key.device)
        head[1:] = key[1:] != key[:-1]
        pos = torch.arange(n, device=key.device)
        start = torch.cummax(torch.where(head, pos, 0), 0).values
        rank = pos - start
        row = self.find(key)
        found = row >= 0
        # new voxels: one row each, appended, then the table re-sorted
        new_keys = key[head & ~found]
        grow = len(new_keys)
        m = len(self.keys)
        if grow:
            new_row = torch.cumsum((head & ~found).to(torch.int64), 0) - 1 + m
            row = torch.where(found, row, new_row)
            self.keys = torch.cat([self.keys, new_keys])
            self.points = torch.cat([self.points, self.points.new_zeros(
                (grow, self.max_points, 3))])
            self.count = torch.cat([self.count, self.count.new_zeros(grow)])
        slot = self.count[row] + rank
        keep = slot < self.max_points
        self.points[row[keep], slot[keep]] = world[keep]
        self.count.index_add_(0, row[keep], torch.ones_like(row[keep]))
        if grow:
            order = torch.argsort(self.keys)
            self.keys, self.points, self.count = (
                self.keys[order], self.points[order], self.count[order])

    def remove_far(self, origin):
        d2 = ((self.points[:, 0] - origin) ** 2).sum(-1)
        keep = d2 <= self.max_distance ** 2
        self.keys, self.points, self.count = (
            self.keys[keep], self.points[keep], self.count[keep])

    def update(self, frame, pose, mm=torch.matmul):
        self.add(mm(frame, pose[:3, :3].T) + pose[:3, 3])
        self.remove_far(pose[:3, 3])

    def neighbours(self, base, offsets):
        """Points of the voxels ``base + offsets``: ((Q, O, K, 3), valid
        (Q, O, K))."""
        row = self.find(pack(base[:, None, :] + offsets[None]))
        ok = row >= 0
        r = row.clamp(min=0)
        pts = self.points[r]
        lane = torch.arange(self.max_points, device=row.device)
        valid = ok[..., None] & (lane < self.count[r][..., None])
        return pts, valid


_OFFSETS = torch.tensor([[dx, dy, dz] for dx in (-1, 0, 1)
                         for dy in (-1, 0, 1) for dz in (-1, 0, 1)])


def _nearest(q, pts, valid):
    """Nearest candidate of each query: (points (Q, 3), distance (Q,))."""
    d2 = ((pts - q[:, None, None, :]) ** 2).sum(-1)
    d2 = torch.where(valid, d2, torch.inf).flatten(1)
    best, idx = d2.min(1)
    return pts.flatten(1, 2)[torch.arange(len(q), device=q.device), idx], \
        torch.sqrt(best)


class KinematicICP:
    """One drive's odometry: ``register(points, timestamps, delta)``
    returns the pose after the frame as a (4, 4) tensor."""

    def __init__(self, cfg: dict, device, precision: str = "float64",
                 extrinsic=None):
        self.cfg = cfg
        dtype, self.mm = PRECISIONS[precision]
        self.dtype = dtype
        self.device = device
        self.ext = (torch.eye(4, dtype=dtype, device=device)
                    if extrinsic is None else
                    torch.as_tensor(extrinsic, dtype=dtype, device=device))
        self.pose = torch.eye(4, dtype=dtype, device=device)
        self.map = VoxelMap(cfg["voxel_size"], cfg["max_range"],
                            cfg["max_points_per_voxel"], dtype, device)
        self.sse = 0.0
        self.samples = 1e-8
        self.offsets = _OFFSETS.to(device)
        assoc = cfg["association"]
        if assoc not in ("exact", "cached"):
            raise ValueError(f"association {assoc!r}")
        self.exact = assoc == "exact"

    def tensor(self, a):
        return torch.as_tensor(a, device=self.device).to(self.dtype)

    def threshold(self):
        c = self.cfg
        if not c["use_adaptive_threshold"]:
            return c["fixed_threshold"]
        res = c["voxel_size"] / math.sqrt(c["max_points_per_voxel"])
        return 3.0 * (res + math.sqrt(self.sse / self.samples))

    def preprocess(self, points, stamps, rel):
        c = self.cfg
        p = points
        if c["deskew"] and stamps is not None and len(stamps) == len(p):
            rel_l = self.mm(self.mm(torch.linalg.inv(self.ext), rel),
                            self.ext)
            xi = se3_log(rel_l)
            M = se3_exp((stamps - 1.0)[:, None] * xi)
            p = self.mm(M[:, :3, :3], p[:, :, None])[..., 0] + M[:, :3, 3]
        r = torch.linalg.vector_norm(p, dim=-1)
        p = p[(r < c["max_range"]) & (r > c["min_range"])]
        return self.mm(p, self.ext[:3, :3].T) + self.ext[:3, 3]

    def world(self, src, pose):
        return self.mm(src, pose[:3, :3].T) + pose[:3, 3]

    def associate(self, src, pose, tau, cache=None):
        q = self.world(src, pose)
        if cache is None:
            pts, valid = self.map.neighbours(
                voxel_of(q, self.cfg["voxel_size"]), self.offsets)
        else:
            pts, valid = cache
        tgt, dist = _nearest(q, pts, valid)
        keep = dist < tau
        return src[keep], tgt[keep]

    def candidates(self, src, guess):
        """The cached candidates: each query's V nearest neighbour boxes
        at the guess, ties to the lower offset."""
        vs = self.cfg["voxel_size"]
        q = self.world(src, guess)
        box = voxel_of(q, vs)[:, None, :] + self.offsets[None]
        lo = box.to(q.dtype) * vs
        gap = torch.clamp(torch.maximum(lo - q[:, None], q[:, None] - lo - vs),
                          min=0)
        lb = (gap * gap).sum(-1)
        pick = torch.sort(lb, dim=1, stable=True).indices[
            :, :self.cfg["candidate_voxels"]]
        pts, valid = self.map.neighbours(voxel_of(q, vs), self.offsets)
        sel = pick[:, :, None, None].expand(-1, -1, *pts.shape[2:])
        return (torch.gather(pts, 1, sel),
                torch.gather(valid, 1, pick[:, :, None].expand(
                    -1, -1, valid.shape[2])))

    def solve(self, src, tgt, pose, beta):
        n = len(src)
        if n == 0:
            return torch.zeros(2, dtype=self.dtype, device=self.device)
        R = pose[:3, :3]
        res = self.world(src, pose) - tgt
        j0 = R[:, 0]
        j1 = -src[:, 1:2] * R[:, 0] + src[:, 0:1] * R[:, 1]
        a01 = (j1 @ j0).sum()
        A = torch.stack([torch.stack([n * (j0 @ j0), a01]),
                         torch.stack([a01, (j1 * j1).sum()])]) / n
        b = torch.stack([(res @ j0).sum(), (j1 * res).sum()]) / n
        A[0, 0] += beta
        return -torch.linalg.solve(A, b)

    def register_motion(self, src, guess, tau):
        c = self.cfg
        if self.map.empty():
            return guess
        cache = None if self.exact else self.candidates(src, guess)
        s, t = self.associate(src, guess, tau, cache)
        if c["use_adaptive_odometry_regularization"]:
            if len(s):
                r = self.world(s, guess) - t
                beta = 1.0 / (float((r * r).sum(-1).mean()) + _TINY)
            else:
                beta = 0.0
        else:
            beta = c["fixed_regularization"]
        pose = guess
        for _ in range(c["max_num_iterations"]):
            dx = self.solve(s, t, pose, beta)
            pose = self.mm(pose, motion_model(dx))
            if float(torch.linalg.vector_norm(dx)) < c["convergence_criterion"]:
                break
            s, t = self.associate(src, pose, tau, cache)
        return pose

    def register(self, points, stamps, rel):
        """One frame (KinematicICP.cpp:48-85 behind the server's gate)."""
        c = self.cfg
        rel = self.tensor(rel)
        if float(torch.linalg.vector_norm(se3_log(rel))) <= STATIONARY_GATE:
            return self.pose
        points = self.tensor(points)
        stamps = None if stamps is None else self.tensor(stamps)
        frame = self.preprocess(points, stamps, rel)
        ds = downsample(frame, c["voxel_size"] * 0.5)
        src = downsample(ds, c["voxel_size"] * 1.5)
        tau = self.threshold()
        guess = self.mm(self.pose, rel)
        new = self.register_motion(src, guess, tau)
        if c["use_adaptive_threshold"]:
            err = self.mm(torch.linalg.inv(guess), new)
            th, _ = rotation_angle(err[:3, :3])
            e = (float(torch.linalg.vector_norm(err[:3, 3]))
                 + 2.0 * c["max_range"] * math.sin(float(th) / 2.0))
            self.sse += e * e
            self.samples += 1.0
        self.map.update(ds, new, self.mm)
        self.pose = new
        return new


def run_drive(drive: dict, cfg: dict, device, precision: str = "float64",
              frames: int | None = None):
    """The poses ((F, 4, 4) float64 numpy) of a drive's first ``frames``
    scans, in ``precision``."""
    odo = KinematicICP(cfg, device, precision, drive["extrinsic"])
    n = len(drive["frames"]) if frames is None else frames
    out = []
    for k in range(n):
        pts, ts = drive["frames"][k]
        out.append(odo.register(pts, ts, drive["rel_odometry"][k])
                   .to(torch.float64).cpu())
    return torch.stack(out).numpy()
