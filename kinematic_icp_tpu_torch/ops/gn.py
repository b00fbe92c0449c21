"""Candidate-cached Gauss-Newton solve: the CUDA kernel and its plain version.

``gn_solve`` runs the whole per-frame GN loop of the candidate-cached
registration (reference Registration.cpp:151-190) in one cooperative
launch of the hand-written kernel ``csrc/gn_solve.cu`` (a persistent grid
of CTAs with one barrier per frame and selection pass), the counterpart of
the JAX package's Pallas kernel (``kinematic_icp_tpu/ops/pallas_gn.py:
_kernel``).  Inputs with a leading batch axis of B frames (the batched
sequence runner's) are solved in ONE launch, up to the card's co-resident
CTA count (``capacity``; a larger batch takes ceil(B / capacity)
launches); a single frame is B = 1 of the same kernel.  A float64 state's
planes and guess are solved in float32, as the plain version solves them,
and the pose comes back in the guess's dtype.  Per frame:

  * nearest-candidate re-selection per iteration among the per-frame cached
    candidates, with the packed-key tie-break of
    ``hashmap.nn_from_candidates``, then the tau gate;
  * adaptive beta from the residuals at the initial guess;
  * the 2x2 normal equations (JTJ/N + diag(beta, 0)), the closed-form
    unicycle delta, convergence on |dx|;
  * ``num_correspondences`` counts the selection at the FINAL pose (the
    kernel re-selects after every update), and the point-space odometry
    error of guess^-1 @ pose comes back with the pose;
  * ``check_crossing`` adds the window-margin exactness certificate.

``gn_solve_reference`` is the plain PyTorch transcription of the same
function.  The wrapper takes it for CPU tensors (and for
``backend="torch"``); for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_graph
from . import cuda_build
from .hashmap import CandidateSet, _candidate_points
from .points import P3

#: far-away coordinate of an invalid candidate: d2 ~ 3e36 stays finite in
#: float32 and its key sorts after every real distance
_FAR = 1e18
_EPSILON = 1e-30

#: kernel launches so far (a plain count, for showing the path ran the
#: kernel); the plain version does not count
LAUNCHES = 0
#: frames solved by those launches (B a launch)
FRAMES = 0
#: of the launches, those of the ``check_crossing`` instance (the certified
#: exact mode's)
CROSSING_LAUNCHES = 0
#: CTAs a frame of the kernel's last cooperative grid (0 before the first
#: launch); the grid holds B times as many
LAST_CTAS = 0
cuda_graph.replayed(__name__, counters=("LAUNCHES", "FRAMES",
                                        "CROSSING_LAUNCHES"),
                    latest=("LAST_CTAS",))


def _params(guess, tau, max_range: float, voxel_size: float):
    """The (16,) float32 block: guess R (row-major), guess t, tau,
    max_range, 1/voxel_size, voxel_size — built on the device."""
    dev = guess.device
    f32 = torch.float32
    if not torch.is_tensor(tau):
        tau = torch.full((), tau, dtype=f32, device=dev)
    return torch.cat([
        guess[:3, :3].to(f32).reshape(9),
        guess[:3, 3].to(f32),
        tau.to(f32).reshape(1),
        torch.full((1,), max_range, dtype=f32, device=dev),
        torch.full((1,), 1.0 / voxel_size, dtype=f32, device=dev),
        torch.full((1,), voxel_size, dtype=f32, device=dev),
    ])


def _motion_delta(dx0, dx1):
    """Unicycle motion model -> (r00, r01, r10, r11, tx, ty) of the SE(3)
    delta (z-axis rotation; row/col 2 are identity)."""
    rho, theta = dx0, dx1
    t2 = theta * theta
    big = torch.abs(theta) >= 1e-3
    safe = torch.where(big, theta, 1.0)
    sinc = torch.where(big, torch.sin(safe) / safe, 1.0 - t2 / 6.0)
    sh = torch.sin(0.5 * safe)
    verc = torch.where(big, 2.0 * sh * sh / safe,
                       theta / 2.0 - t2 * theta / 24.0)
    vx = rho * sinc
    vy = rho * verc
    ct = torch.where(big, torch.cos(safe), 1.0 - t2 / 2.0 + t2 * t2 / 24.0)
    st = torch.where(big, torch.sin(safe), theta - t2 * theta / 6.0)
    b_c = 0.5 - t2 / 24.0 + t2 * t2 / 720.0
    c_c = 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0
    bb = torch.where(big, 2.0 * (sh / safe) * sh, b_c * theta)  # B*theta
    cc = torch.where(big, (1.0 - sinc) / safe, c_c * theta)     # C*theta
    v00 = 1.0 - cc * theta
    tx = v00 * vx - bb * vy
    ty = bb * vx + v00 * vy
    return ct, -st, st, ct, tx, ty


def gn_solve_reference(cand: CandidateSet, source, source_mask, guess, tau, *,
                       voxel_size: float, max_num_iterations: int,
                       convergence_criterion: float,
                       use_adaptive_regularization: bool,
                       fixed_regularization: float,
                       max_range: float = 0.0,
                       check_crossing: bool = False):
    """Plain PyTorch version of the kernel; same arguments and outputs as
    ``gn_solve``.  A leading batch axis solves the frames one after the
    other, each as an unbatched call.

    The data-dependent ``while`` loop becomes ``max_num_iterations`` trips
    whose updates are masked once the loop would have stopped, so the
    function reads nothing back to the host.
    """
    kw = dict(voxel_size=voxel_size, max_num_iterations=max_num_iterations,
              convergence_criterion=convergence_criterion,
              use_adaptive_regularization=use_adaptive_regularization,
              fixed_regularization=fixed_regularization, max_range=max_range,
              check_crossing=check_crossing)
    if cand.words.dim() == 4:
        tau = torch.as_tensor(tau, device=guess.device).expand(
            guess.shape[0])
        outs = [gn_solve_reference(
            CandidateSet(*(t[b] for t in cand)), P3(*(t[b] for t in source)),
            source_mask[b], guess[b], tau[b], **kw)
            for b in range(guess.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))
    v, k, n = cand.words.shape
    if k > 32:
        raise ValueError("packed tie-break key holds a 5-bit entry lane")
    f32 = torch.float32
    P = _params(guess, tau, max_range, voxel_size)
    tau = P[12]
    pts, valid = _candidate_points(cand, voxel_size, f32)
    px = torch.where(valid, pts.x, _FAR).reshape(v * k, n)
    py = torch.where(valid, pts.y, _FAR).reshape(v * k, n)
    pz = torch.where(valid, pts.z, _FAR).reshape(v * k, n)
    lane = torch.arange(k, dtype=torch.int32, device=px.device)[None, :, None]
    tag = ((cand.rel[:, None, :] << 5) | lane).reshape(v * k, n)
    sx, sy, sz = source.x.to(f32), source.y.to(f32), source.z.to(f32)
    sm = source_mask.to(f32)
    if check_crossing:
        bx, by, bz = (cand.base_x.to(f32), cand.base_y.to(f32),
                      cand.base_z.to(f32))

    def world(pose):
        r00, r01, r02, r10, r11, r12, r20, r21, r22, t0, t1, t2 = pose
        return (r00 * sx + r01 * sy + r02 * sz + t0,
                r10 * sx + r11 * sy + r12 * sz + t1,
                r20 * sx + r21 * sy + r22 * sz + t2)

    def select(pose):
        """Nearest candidate + tau gate (+ the certificate's violations)."""
        wx, wy, wz = world(pose)
        dx = px - wx
        dy = py - wy
        dz = pz - wz
        d2 = dx * dx + dy * dy + dz * dz                        # (VK, N)
        # every key is < 2^31 for d2 >= 0, so the signed min keeps order
        key = (d2.view(torch.int32) & ~0x3FF) | tag
        idx = key.argmin(0, keepdim=True)                        # unique tags
        nx = px.gather(0, idx)[0]
        ny = py.gather(0, idx)[0]
        nz = pz.gather(0, idx)[0]
        ex = nx - wx
        ey = ny - wy
        ez = nz - wz
        dw2 = ex * ex + ey * ey + ez * ez
        corr = sm * (torch.sqrt(dw2) < tau).to(f32)
        if not check_crossing:
            return nx, ny, nz, corr, torch.zeros((), dtype=f32,
                                                 device=px.device)
        # Window-margin certificate (see the kernel's comment).
        vs = P[15]
        mx = torch.minimum(wx - (bx - 1.0) * vs, (bx + 2.0) * vs - wx)
        my = torch.minimum(wy - (by - 1.0) * vs, (by + 2.0) * vs - wy)
        mz = torch.minimum(wz - (bz - 1.0) * vs, (bz + 2.0) * vs - wz)
        margin = torch.clamp(
            torch.minimum(torch.minimum(torch.minimum(mx, my), mz), vs),
            min=0.0)
        cap2 = torch.minimum(dw2, tau * tau)
        cap2 = ((cap2.view(torch.int32) | 0x3FF) + 0x400).view(f32)
        viol = torch.sum(sm * (cap2 >= margin * margin).to(f32))
        return nx, ny, nz, corr, viol

    def normal_eqs(pose, nx, ny, nz, corr):
        r00, r01, r02, r10, r11, r12, r20, r21, r22 = pose[:9]
        wx, wy, wz = world(pose)
        rx = wx - nx
        ry = wy - ny
        rz = wz - nz
        j1x = -sy * r00 + sx * r01
        j1y = -sy * r10 + sx * r11
        j1z = -sy * r20 + sx * r21
        j1_dot_j0 = j1x * r00 + j1y * r10 + j1z * r20
        j1_dot_j1 = j1x * j1x + j1y * j1y + j1z * j1z
        r_dot_j0 = rx * r00 + ry * r10 + rz * r20
        r_dot_j1 = rx * j1x + ry * j1y + rz * j1z
        n_ = torch.sum(corr)
        return (n_ * (r00 * r00 + r10 * r10 + r20 * r20),
                torch.sum(corr * j1_dot_j0), torch.sum(corr * j1_dot_j1),
                torch.sum(corr * r_dot_j0), torch.sum(corr * r_dot_j1), n_)

    pose = tuple(P[i] for i in range(12))
    nx, ny, nz, corr, crossed = select(pose)
    if use_adaptive_regularization:
        wx, wy, wz = world(pose)
        rx = wx - nx
        ry = wy - ny
        rz = wz - nz
        sq = rx * rx + ry * ry + rz * rz
        ncorr0 = torch.sum(corr)
        mean = torch.sum(corr * sq) / torch.clamp(ncorr0, min=1.0)
        beta = torch.where(ncorr0 > 0, 1.0 / (mean + _EPSILON), 0.0)
    else:
        beta = torch.full((), fixed_regularization, dtype=f32,
                          device=px.device)

    it = torch.zeros((), dtype=torch.int32, device=px.device)
    conv = torch.zeros((), dtype=torch.bool, device=px.device)
    for _ in range(max_num_iterations):
        live = ~conv  # the kernel's loop would still run this trip
        (r00, r01, r02, r10, r11, r12, r20, r21, r22, t0, t1, t2) = pose
        a00, a01, a11, b0, b1, n_ = normal_eqs(pose, nx, ny, nz, corr)
        nsafe = torch.clamp(n_, min=1.0)
        a00 = a00 / nsafe + beta
        a01 = a01 / nsafe
        a11 = a11 / nsafe
        b0 = b0 / nsafe
        b1 = b1 / nsafe
        det = a00 * a11 - a01 * a01
        safe_det = torch.where(torch.abs(det) > _EPSILON, det, 1.0)
        dx0 = -(a11 * b0 - a01 * b1) / safe_det
        dx1 = -(a00 * b1 - a01 * b0) / safe_det
        ok = (n_ > 0) & (torch.abs(det) > _EPSILON)
        dx0 = torch.where(ok, dx0, 0.0)
        dx1 = torch.where(ok, dx1, 0.0)
        d00, d01, d10, d11, dtx, dty = _motion_delta(dx0, dx1)
        new_pose = (r00 * d00 + r01 * d10, r00 * d01 + r01 * d11, r02,
                    r10 * d00 + r11 * d10, r10 * d01 + r11 * d11, r12,
                    r20 * d00 + r21 * d10, r20 * d01 + r21 * d11, r22,
                    r00 * dtx + r01 * dty + t0,
                    r10 * dtx + r11 * dty + t1,
                    r20 * dtx + r21 * dty + t2)
        new_it = it + 1
        new_conv = torch.sqrt(dx0 * dx0 + dx1 * dx1) < convergence_criterion
        nx2, ny2, nz2, corr2, cr2 = select(new_pose)
        # only a selection that feeds a further iteration counts
        used = ~new_conv & (new_it < max_num_iterations)
        pose = tuple(torch.where(live, a, b) for a, b in zip(new_pose, pose))
        nx, ny, nz, corr = (torch.where(live, a, b) for a, b in
                            zip((nx2, ny2, nz2, corr2), (nx, ny, nz, corr)))
        crossed = crossed + torch.where(live & used, cr2, 0.0)
        it = torch.where(live, new_it, it)
        conv = conv | (live & new_conv)

    (r00, r01, r02, r10, r11, r12, r20, r21, r22, t0, t1, t2) = pose
    z = 0.0 * t0
    pose44 = torch.stack([r00, r01, r02, t0, r10, r11, r12, t1,
                          r20, r21, r22, t2, z, z, z, 1.0 + z]).reshape(4, 4)
    # point-space odometry error of E = guess^-1 @ pose
    # (CorrespondenceThreshold.cpp:7-12): |t_E| = |t - t_guess| and
    # trace(R_guess^T R) is the Frobenius product of the rotation blocks
    dtx = t0 - P[9]
    dty = t1 - P[10]
    dtz = t2 - P[11]
    dt = torch.sqrt(dtx * dtx + dty * dty + dtz * dtz)
    frob = (r00 * P[0] + r01 * P[1] + r02 * P[2]
            + r10 * P[3] + r11 * P[4] + r12 * P[5]
            + r20 * P[6] + r21 * P[7] + r22 * P[8])
    c = torch.clamp((frob - 1.0) * 0.5, -1.0, 1.0)
    err = dt + 2.0 * P[13] * torch.sqrt(torch.clamp((1.0 - c) * 0.5, min=0.0))
    return (pose44.to(guess.dtype), it, torch.sum(corr).to(torch.int32), err,
            crossed > 0)


def error_tolerance(pose, guess, max_range: float, pose_diff: float) -> float:
    """How far ``odometry_error_pt`` (2 R sqrt(h) + |dt|) may move between
    two solves with the same per-element rounding whose (4, 4) poses differ
    by at most ``pose_diff``, as the kernel and its plain version do.

    h = (1 - c)/2, with c from the nine-product trace of Rg^T R, moves by
    3/4 * pose_diff, and sqrt turns dh into R dh / sqrt(h).  With equal
    poses this is 0.
    """
    frob = sum(float(pose[i][j]) * float(guess[i][j])
               for i in range(3) for j in range(3))
    h = max((1.0 - (frob - 1.0) * 0.5) * 0.5, 0.0)
    dh = 3.0 * pose_diff / 4.0
    dsqrt = min(dh / max(h ** 0.5, 1e-30), dh ** 0.5)
    return 2.0 * max_range * dsqrt + 3.0 * pose_diff


def _kernel_entry():
    """``kicp_gn_solve`` of the built library, with its C signature."""
    fn = cuda_build.load("gn_solve").kicp_gn_solve
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([p] * 15 + [i] * 5 + [f, i, f, f, f, i,
                                              ctypes.POINTER(i),
                                              ctypes.POINTER(i), p])
        fn.restype = i
    return fn


#: (device index, check_crossing) -> frames one launch takes at most
_CAPACITY: dict[tuple[int, bool], int] = {}


def capacity(dev: torch.device, check_crossing: bool) -> int:
    """The co-resident CTA count of the kernel's instance on ``dev``: the
    most frames one cooperative launch solves (one CTA a frame at least).
    Queried from the library once per device and instance."""
    key = (dev.index if dev.index is not None else
           torch.cuda.current_device(), bool(check_crossing))
    if key not in _CAPACITY:
        fn = cuda_build.load("gn_solve").kicp_gn_capacity
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            rc = fn(int(check_crossing), ctypes.byref(out))
        if rc != 0 or out.value < 1:
            raise RuntimeError(
                f"gn_solve kernel: no cooperative launch on {dev} (CUDA "
                f"error {rc}, {out.value} co-resident CTAs)")
        _CAPACITY[key] = out.value
    return _CAPACITY[key]


def _check(name, t, dtype, shape, dev):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"gn_solve kernel: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {dev}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def _gn_solve_cuda(cand, source, source_mask, guess, tau, *, voxel_size,
                   max_num_iterations, convergence_criterion,
                   use_adaptive_regularization, fixed_regularization,
                   max_range, check_crossing):
    """One cooperative launch of the kernel for the B frames of a batched
    call (B = 1 for an unbatched one), or ceil(B / capacity) launches of at
    most ``capacity(dev)`` frames each where B exceeds the card's
    co-resident CTAs (a frame's bits depend on its N alone, so the split
    changes none).  No other device work but the copies that make a strided
    input dense or a float64 input float32, as the plain version casts: the
    kernel reads ``guess``, ``tau`` and the bool mask where they lie, and
    takes the scalars by value.  The pose comes back in the guess's
    dtype."""
    global LAUNCHES, FRAMES, CROSSING_LAUNCHES, LAST_CTAS
    batched = cand.words.dim() == 4
    if not batched:
        cand = CandidateSet(*(t[None] for t in cand))
        source = P3(*(t[None] for t in source))
        source_mask, guess = source_mask[None], guess[None]
    if cand.words.dim() != 4:
        raise ValueError(f"gn_solve kernel: words must be (V, K, N) or "
                         f"(B, V, K, N); got {tuple(cand.words.shape)}")
    b, v, k, n = cand.words.shape
    if not (1 <= v <= 27 and 1 <= k <= 32 and n >= 1 and b >= 1):
        raise ValueError(f"gn_solve kernel takes V <= 27, K <= 32; got "
                         f"{(b, v, k, n)}")
    dev = cand.words.device
    i32, f32 = torch.int32, torch.float32
    _check("words", cand.words, i32, (b, v, k, n), dev)
    _check("rel", cand.rel, i32, (b, v, n), dev)
    for name in ("base_x", "base_y", "base_z"):
        _check(name, getattr(cand, name), i32, (b, n), dev)
    # no-ops for dense float32 planes (an unbatched frame's); copies of the
    # rows of a batch's truncated (strided) source planes, or of float64
    # planes and guess (a float64 state's)
    sx, sy, sz = (t.to(f32).contiguous() for t in source)
    for name, t in zip("xyz", (sx, sy, sz)):
        _check(f"source.{name}", t, f32, (b, n), dev)
    _check("source_mask", source_mask, torch.bool, (b, n), dev)
    if guess.dtype not in (f32, torch.float64):
        raise ValueError(f"gn_solve kernel: guess must be float32 or "
                         f"float64; got {guess.dtype}")
    guess32 = guess.to(f32).contiguous()
    _check("guess", guess32, f32, (b, 4, 4), dev)
    if torch.is_tensor(tau):  # a no-op for the pipeline's f32 tau
        tau = tau.to(device=dev, dtype=f32).expand(b).contiguous()
    else:
        tau = torch.full((b,), tau, dtype=f32, device=dev)
    per_launch = capacity(dev, check_crossing)
    tiles = (n + 31) // 32
    pose16 = torch.empty((b, 16), dtype=f32, device=dev)
    stats = torch.empty((b, 3), dtype=i32, device=dev)
    err = torch.empty(b, dtype=f32, device=dev)
    # per pass parity, frame and 32-query tile 8 floats of slots, then 32
    # words of barrier a frame, for the largest launch; the launches of a
    # split run one after the other on the stream, and each zeroes its
    # barrier words, so they share it
    most = min(b, per_launch)
    partials = torch.empty(2 * most * tiles * 8 + 32 * most, dtype=f32,
                           device=dev)
    ctas, cap = ctypes.c_int(0), ctypes.c_int(0)
    frame_major = (guess32, tau, *cand, sx, sy, sz, source_mask, pose16,
                   stats, err)

    fn = _kernel_entry()
    # tau, the source copies and the scratch may be freed on return while
    # the kernel still uses them: the caching allocator hands their memory
    # only to later work on this stream, which runs after the kernel
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for first in range(0, b, per_launch):
            frames = min(per_launch, b - first)
            # frame `first` of each dense (B, ...) tensor
            ptrs = [t.data_ptr() + first * t.stride(0) * t.element_size()
                    for t in frame_major]
            rc = fn(*ptrs, partials.data_ptr(), frames, v,
                    k, n, max_num_iterations, convergence_criterion,
                    int(use_adaptive_regularization), fixed_regularization,
                    voxel_size, max_range, int(check_crossing),
                    ctypes.byref(ctas), ctypes.byref(cap), stream)
            if rc != 0:
                raise RuntimeError(
                    f"gn_solve kernel launch of {frames} frames failed: "
                    f"CUDA error {rc} (co-resident CTAs {cap.value})")
            LAUNCHES += 1
            FRAMES += frames
            CROSSING_LAUNCHES += int(check_crossing)
            LAST_CTAS = ctas.value
    # stats[:, 2] is 0 or 1; its low byte (little-endian) read as a bool is
    # `crossed` without a comparison kernel
    crossed = stats.view(torch.bool)[:, 8]
    out = (pose16.view(b, 4, 4).to(guess.dtype), stats[:, 0], stats[:, 1],
           err, crossed)
    return out if batched else tuple(t[0] for t in out)


def gn_solve(cand: CandidateSet, source, source_mask, guess, tau, *,
             voxel_size: float, max_num_iterations: int,
             convergence_criterion: float,
             use_adaptive_regularization: bool,
             fixed_regularization: float,
             max_range: float = 0.0,
             check_crossing: bool = False,
             backend: str = "auto"):
    """Run the whole candidate-cached GN solve of one frame, or of a batch.

    Args mirror the candidate-cached branch of
    ``registration.compute_robot_motion``; ``guess`` is the (4, 4) initial
    pose and ``tau`` the correspondence threshold.  Returns (pose (4, 4),
    iterations, num_correspondences, odometry_error_pt, crossed), all
    tensors on the input's device.  With a leading batch axis (``cand``
    (B, V, K, N) words and (B, V, N) rel, (B, N) bases, sources and mask,
    ``guess`` (B, 4, 4), ``tau`` (B,)) each output gains it, and the
    kernel solves the B frames in one launch (ceil(B / capacity) where B
    exceeds the card's co-resident CTAs).

    ``backend``: ``"torch"`` runs the plain version on any device (the
    comparison baseline); ``"auto"`` and ``"cuda"`` launch the kernel for
    CUDA tensors.  CPU tensors always take the plain version.
    """
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"backend {backend!r}")
    kw = dict(voxel_size=voxel_size, max_num_iterations=max_num_iterations,
              convergence_criterion=convergence_criterion,
              use_adaptive_regularization=use_adaptive_regularization,
              fixed_regularization=fixed_regularization, max_range=max_range,
              check_crossing=check_crossing)
    dev = cand.words.device
    if dev.type == "cpu" or backend == "torch":
        return gn_solve_reference(cand, source, source_mask, guess, tau, **kw)
    if dev.type != "cuda":
        raise ValueError(f"gn_solve: unsupported device {dev}")
    return _gn_solve_cuda(cand, source, source_mask, guess, tau, **kw)
