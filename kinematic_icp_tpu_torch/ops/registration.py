"""Kinematically-constrained ICP (2-DoF Gauss-Newton on the unicycle model).

Equivalent of ``kinematic_icp::KinematicRegistration``
(Registration.cpp:151-190):

  * initial guess = ``last_pose * relative_wheel_odometry``       (cpp:156)
  * data association: NN lookup in the voxel map, keep dist < tau (cpp:62-81)
  * adaptive Tikhonov regularizer beta = 1/mean residual^2 from the initial
    guess (cpp:48-60)
  * per iteration: 2x2 normal equations ``JTJ/N + diag(beta, 0)``, solve,
    compose through the unicycle motion model, re-associate, stop when
    ``|dx| < convergence_criterion``                               (cpp:179-187)

``compute_robot_motion`` has the JAX package's four branches: the
candidate-cached solve (default), the certified exact solve, pruned-exact
and the plain full-27 re-gather loop.  The kernel branches go through
``gn.gn_solve`` (the CUDA kernel ``csrc/gn_solve.cu``, or its plain version
on CPU tensors); the loop branches are ``run_gn``, plain torch ops.  With
no correspondences the update is forced to zero and the guess comes back,
matching the reference's early return for an empty map (cpp:157).

Every branch also takes a batch of B sequences: (B, NB, G*R) tables, (B,
N) sources, (B, 4, 4) poses and (B,) taus, every solve of the batch in one
kernel launch (or, on the loop branches, the loop with a (B,) convergence
mask).  Where JAX's ``vmap`` turns a ``lax.cond`` of the exact modes into
a per-row select, the port runs the full-27 loop on the whole batch where
any of the (B,) fallback flags is set and takes its rows where the flag is
set: on the device under a captured frame (``utils.cuda_graph.branch``, a
conditional graph node), after one read-back of the flags eagerly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..utils import cuda_graph
from . import gn, hashmap, motion_model, se3
from . import points
from .points import P3, per_row, row_sum, transform

#: the reference uses DBL_MIN; a float32-safe tiny value serves the same purpose
_EPSILON = 1e-30


class RegistrationDebug(NamedTuple):
    iterations: torch.Tensor           # int32 — GN iterations executed
    #: int32 — the kernel branch counts the selection at the final pose,
    #: the loop branches the association before the last update
    num_correspondences: torch.Tensor
    #: scalar f32 — the adaptive threshold's point-space error
    #: |t_err| + 2 R sin(theta_err/2) of guess^-1 @ pose, from the kernel
    #: branches; None on the loop branches, where the pipeline computes it
    #: from the returned pose
    odometry_error_pt: torch.Tensor | None = None
    #: scalar bool ((B,) in a batch) — an exact mode's certificate failed
    #: this frame and the full-27 loop recomputed the solve; None outside
    #: the certified and pruned-exact branches
    exact_fallback: torch.Tensor | None = None
    #: int32 — the iterations of the frame's first solve (the kernel's
    #: passes on the certified branch) where an exact mode may re-solve
    #: through the full-27 loop, whose trips ``iterations`` then holds;
    #: None where ``iterations`` is the only solve's
    solve_iterations: torch.Tensor | None = None


def data_association(m: hashmap.MapState, source: P3, source_mask, pose,
                     max_correspondence_distance, voxel_size: float,
                     max_probes: int, num_candidate_voxels: int = 27):
    """Associate local-frame source points to map points
    (Registration.cpp:62-81).  Returns (targets P3, corr_mask (N,))."""
    world = transform(pose, source)
    targets, dist = hashmap.nearest_neighbor(
        m, world, source_mask, voxel_size, max_probes, num_candidate_voxels)
    return targets, source_mask & (dist < per_row(max_correspondence_distance))


def associate_from_candidates(cand, source: P3, source_mask, pose,
                              max_correspondence_distance, voxel_size: float):
    """Re-associate against a cached CandidateSet (re-selection only)."""
    world = transform(pose, source)
    targets, dist = hashmap.nn_from_candidates(cand, world, source_mask,
                                               voxel_size)
    return targets, source_mask & (dist < per_row(max_correspondence_distance))


def _residual(source: P3, targets: P3, pose):
    return points.sub(transform(pose, source), targets)


def partial_residual_sse(source: P3, targets: P3, corr_mask, pose):
    """(..., 2) (sse, n) sums of squared residuals over the
    correspondences (``row_sum``: the same bits for a row at any batch)."""
    sq = points.norm2(_residual(source, targets, pose))
    return row_sum(torch.stack([torch.where(corr_mask, sq, 0.0),
                                corr_mask.to(source.x.dtype)], dim=-2))


def regularization_from_sums(sums):
    """beta = 1 / (sse/n + eps); 0 with no correspondences."""
    sse, n = sums[..., 0], sums[..., 1]
    mean = sse / torch.clamp(n, min=1.0)
    beta = 1.0 / (mean + _EPSILON)
    return torch.where(n > 0, beta, 0.0)


def compute_odometry_regularization(source: P3, targets: P3, corr_mask, pose):
    """beta = 1 / (mean ||T s - t||^2 + eps)  (Registration.cpp:48-60)."""
    return regularization_from_sums(
        partial_residual_sse(source, targets, corr_mask, pose))


def partial_normal_equations(source: P3, targets: P3, corr_mask, pose):
    """Masked sums of the 2x2 normal equations, (..., 6): (a00, a01, a11,
    b0, b1, n), with residual_i = T s_i - t_i and J_i = [R e_x | R (-s_y,
    s_x, 0)] (Registration.cpp:89-91)."""
    def e(i, j):
        return per_row(pose[..., i, j])

    r = _residual(source, targets, pose)
    j0x, j0y, j0z = e(0, 0), e(1, 0), e(2, 0)
    j1x = -source.y * e(0, 0) + source.x * e(0, 1)
    j1y = -source.y * e(1, 0) + source.x * e(1, 1)
    j1z = -source.y * e(2, 0) + source.x * e(2, 1)

    w = corr_mask.to(source.x.dtype)
    j1_dot_j0 = j1x * j0x + j1y * j0y + j1z * j0z
    j1_dot_j1 = j1x * j1x + j1y * j1y + j1z * j1z
    r_dot_j0 = r.x * j0x + r.y * j0y + r.z * j0z
    r_dot_j1 = r.x * j1x + r.y * j1y + r.z * j1z

    # one fixed-order tree for the five sums (``row_sum``)
    n, a01, a11, b0, b1 = row_sum(torch.stack(
        [w, w * j1_dot_j0, w * j1_dot_j1, w * r_dot_j0, w * r_dot_j1],
        dim=-2)).unbind(-1)
    r00, r10, r20 = pose[..., 0, 0], pose[..., 1, 0], pose[..., 2, 0]
    return torch.stack([n * (r00 * r00 + r10 * r10 + r20 * r20),
                        a01, a11, b0, b1, n], dim=-1)


def solve_normal_equations(sums, beta):
    """dx = -(JTJ/N + diag(beta, 0))^-1 JTr/N; zero with no
    correspondences or a singular system."""
    a00, a01, a11, b0, b1, n_corr = (sums[..., i] for i in range(6))
    n = torch.clamp(n_corr, min=1.0)
    a00, a01, a11 = a00 / n, a01 / n, a11 / n
    b0, b1 = b0 / n, b1 / n
    a00 = a00 + beta
    det = a00 * a11 - a01 * a01
    safe_det = torch.where(torch.abs(det) > _EPSILON, det, 1.0)
    dx = torch.stack([-(a11 * b0 - a01 * b1) / safe_det,
                      -(a00 * b1 - a01 * b0) / safe_det], dim=-1)
    ok = (n_corr > 0) & (torch.abs(det) > _EPSILON)
    return torch.where(ok[..., None], dx, torch.zeros_like(dx))


def compute_perturbation(source: P3, targets: P3, corr_mask, pose, beta):
    """One device's perturbation (Registration.cpp:83-126)."""
    return solve_normal_equations(
        partial_normal_equations(source, targets, corr_mask, pose), beta)


def _always(pred, body):
    """``body()``, whatever ``pred`` says (``run_gn(gated=False)``)."""
    body()


def run_gn(associate, source: P3, guess, *, max_num_iterations: int,
           convergence_criterion: float,
           use_adaptive_odometry_regularization: bool,
           fixed_regularization: float, reduce=None, gated: bool = True):
    """The reference GN loop over ``associate(pose) -> (targets, corr_mask,
    violation or None)``.  Returns (pose, iterations, num_correspondences,
    any violation or None).

    JAX's data-dependent ``while`` loop: the first trip runs, and each
    later trip runs inside ``cuda_graph.when`` on "some row has not
    converged"; inside a trip the re-association runs only where some row
    goes on (Registration.cpp:185-186), inside a nested ``when``.  Captured,
    the loop stops on the device where JAX's does and skips the
    re-associations JAX's ``lax.cond`` skips; eagerly every trip runs, its
    updates masked once a row would have stopped, which gives the same
    bits.  The trip's carry (pose, targets, mask, iterations, convergence,
    violation) lives in tensors made before the first trip, which each trip
    rewrites in place.  ``num_correspondences`` counts the association
    before the last update, and a certificate violation counts only from an
    association the while loop would have made.  With a batch of (B, 4, 4)
    guesses each sequence keeps its own convergence mask (a trip runs while
    any row is live), and its float sums are ``points.row_sum``s, so a
    sequence's bits do not depend on B.

    ``reduce`` (the map-sharded path's sum over the shards) is applied to
    the residual sums, each trip's normal-equation sums and the final
    correspondence count, and ``associate`` may issue collectives of its
    own (the sharded path's minimum over the shards).  The loop gates
    them as it gates everything else, and that is safe because every
    predicate it gates on is computed from reduced values only: ``conv``
    from ``dx``, ``dx`` from the reduced normal equations, ``use`` from
    ``conv`` and the trip's ``new_conv``.  So every rank of a map group
    takes the same branch at every gate and issues the same collectives
    in the same order.  A value local to a rank (such as the certificate
    ``viol``, None on the sharded path) never gates a body.

    ``gated=False`` runs every trip and every re-association, masked, as
    ``when`` runs them eagerly, also under capture (no conditional node,
    the same bits): the sharded path's "nccl" route, whose collectives a
    conditional body cannot hold.
    """
    total = reduce if reduce is not None else (lambda sums: sums)
    when = cuda_graph.when if gated else _always
    targets, corr_mask, viol = associate(guess)
    if use_adaptive_odometry_regularization:
        beta = regularization_from_sums(total(partial_residual_sse(
            source, targets, corr_mask, guess)))
    else:
        beta = torch.full(guess.shape[:-2], fixed_regularization,
                          dtype=source.x.dtype, device=source.x.device)
    pose = guess.clone()
    it = torch.zeros(guess.shape[:-2], dtype=torch.int32, device=guess.device)
    conv = torch.zeros(guess.shape[:-2], dtype=torch.bool,
                       device=guess.device)

    def trip(last: bool):
        live = ~conv  # the while loop runs this trip for these rows
        dx = solve_normal_equations(total(partial_normal_equations(
            source, targets, corr_mask, pose)), beta)
        new_pose = se3.compose44(pose, motion_model.motion_model(dx))
        new_conv = torch.linalg.vector_norm(dx, dim=-1) < convergence_criterion
        if not last:
            use = live & ~new_conv

            def reassociate():
                t2, c2, v2 = associate(new_pose)
                for dst, src in zip(targets, points.where(use, t2, targets)):
                    dst.copy_(src)
                corr_mask.copy_(torch.where(per_row(use), c2, corr_mask))
                if viol is not None:
                    viol.copy_(viol | (use & v2))

            when(use.any(), reassociate)
        pose.copy_(torch.where(per_row(live, 2), new_pose, pose))
        it.copy_(torch.where(live, it + 1, it))
        conv.copy_(conv | (live & new_conv))

    for n in range(max_num_iterations):
        last = n + 1 == max_num_iterations
        if n == 0:
            trip(last)
        else:
            when((~conv).any(), functools.partial(trip, last))
    return pose, it, total(corr_mask.sum(-1).to(torch.int32)), viol


def _resolve_backend(gn_backend: str, device) -> str:
    """"cuda" takes the kernel branches, "torch" the loop branches (JAX's
    "xla"); "auto" is "cuda" for CUDA tensors and "torch" otherwise."""
    if gn_backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"gn_backend {gn_backend!r}")
    if gn_backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    return gn_backend


def compute_robot_motion(m: hashmap.MapState, source: P3, source_mask,
                         last_pose, relative_wheel_odometry,
                         max_correspondence_distance,
                         *, voxel_size: float, max_probes: int,
                         max_num_iterations: int, convergence_criterion: float,
                         use_adaptive_odometry_regularization: bool,
                         fixed_regularization: float,
                         num_candidate_voxels: int = 27,
                         exact_gn_reassociation: bool = False,
                         exact_prune_candidates: int = 0,
                         gn_candidates_per_voxel: int = 0,
                         gn_backend: str = "auto",
                         threshold_max_range: float = 0.0):
    """Full ComputeRobotMotion (Registration.cpp:151-190).

    By default candidate map points are gathered once at the initial guess
    and the GN iterations re-select among them (``gn_candidates_per_voxel``
    keeps each voxel's nearest few).  ``exact_gn_reassociation`` restores
    the reference's full 27-voxel re-gather per iteration:

      * "cuda": the kernel's certified solve on the 27-voxel cache; a frame
        whose window-margin certificate fails re-solves through the full-27
        loop;
      * "torch" with ``0 < exact_prune_candidates < 27``: each association
        gathers only the V nearest voxels and checks that no skipped voxel
        could have beaten or tied its neighbour within tau; a frame with
        any violation re-solves through the full-27 loop, so every frame
        equals the full loop bit for bit;
      * "torch" otherwise: the full-27 loop.

    Where JAX's exact modes branch on the device (``lax.cond``), the
    port's fallback is a branch point (``utils.cuda_graph.branch``): in a
    captured frame a conditional node on the flag, which runs the full-27
    loop on the device only on frames that set it; eagerly the flag read
    back once a frame.  The default branch reads nothing back.  Returns
    (new_pose (4, 4), RegistrationDebug).

    Every branch takes a batch: (B, NB, G*R) table, (B, N) sources, (B, 4,
    4) poses and odometry, (B,) tau; it returns (B, 4, 4) poses and (B,)
    debug values.  Where any of an exact mode's (B,) flags is set, the
    full-27 loop runs on the batch and each row whose flag is set takes
    the loop's result, so every row equals its own unbatched solve.
    """
    backend = _resolve_backend(gn_backend, source.x.device)
    # a no-op for the 0-d float32 tau of the pipeline
    max_correspondence_distance = torch.as_tensor(
        max_correspondence_distance, dtype=source.x.dtype,
        device=source.x.device)
    guess = se3.compose44(last_pose, relative_wheel_odometry)
    loop = dict(max_num_iterations=max_num_iterations,
                convergence_criterion=convergence_criterion,
                use_adaptive_odometry_regularization=(
                    use_adaptive_odometry_regularization),
                fixed_regularization=fixed_regularization)
    kernel = dict(voxel_size=voxel_size,
                  max_num_iterations=max_num_iterations,
                  convergence_criterion=convergence_criterion,
                  use_adaptive_regularization=(
                      use_adaptive_odometry_regularization),
                  fixed_regularization=fixed_regularization,
                  max_range=threshold_max_range, backend="cuda")

    def associate_full(pose):
        t, c = data_association(m, source, source_mask, pose,
                                max_correspondence_distance, voxel_size,
                                max_probes, 27)
        return t, c, None

    def full_loop():
        return run_gn(associate_full, source, guess, **loop)[:3]

    if not exact_gn_reassociation:
        world_guess = transform(guess, source)
        cand = hashmap.gather_candidates(m, world_guess, voxel_size,
                                         max_probes, num_candidate_voxels)
        if gn_candidates_per_voxel:
            cand = hashmap.reduce_candidates(cand, world_guess,
                                             gn_candidates_per_voxel,
                                             voxel_size)
        if backend == "cuda":
            pose, iters, ncorr, err, _ = gn.gn_solve(
                cand, source, source_mask, guess,
                max_correspondence_distance, **kernel)
            return pose, RegistrationDebug(iterations=iters,
                                           num_correspondences=ncorr,
                                           odometry_error_pt=err)

        def associate_cached(pose):
            t, c = associate_from_candidates(cand, source, source_mask, pose,
                                             max_correspondence_distance,
                                             voxel_size)
            return t, c, None

        pose, iters, ncorr, _ = run_gn(associate_cached, source, guess,
                                       **loop)
        return pose, RegistrationDebug(iterations=iters,
                                       num_correspondences=ncorr)

    def fall_back_where(flag, *solved):
        """``solved`` (pose, iterations, correspondences[, point-space
        error]) with the full-27 loop's values in each row whose ``flag``
        is set, as JAX's vmapped ``lax.cond`` selects them; the loop runs
        only when some row is set (a branch point of the frame)."""
        def fallback():
            looped = full_loop()
            if len(solved) == 4:
                looped += (_point_error(looped[0], guess,
                                        threshold_max_range),)
            return tuple(
                torch.where(per_row(flag, a.dim() - flag.dim()), a, b)
                for a, b in zip(looped, solved))

        return cuda_graph.branch(flag, fallback, solved)

    if backend == "cuda":
        # Certified solve: while the window-margin certificate holds, the
        # cached re-selection IS the reference's re-gather (frozen map,
        # sufficient margin); a violating frame re-solves through the loop.
        cand = hashmap.gather_candidates(m, transform(guess, source),
                                         voxel_size, max_probes, 27)
        *solved, crossed = gn.gn_solve(
            cand, source, source_mask, guess, max_correspondence_distance,
            check_crossing=True, **kernel)
        # a captured branch rewrites ``solved`` in place
        passes = solved[1].clone()
        pose, iters, ncorr, err = fall_back_where(crossed, *solved)
        return pose, RegistrationDebug(
            iterations=iters, num_correspondences=ncorr,
            odometry_error_pt=err, exact_fallback=crossed,
            solve_iterations=passes)

    if 0 < exact_prune_candidates < 27:
        tau = per_row(max_correspondence_distance)
        tau2 = tau * tau

        def associate_pruned(pose):
            world = transform(pose, source)
            cand, skip_lb_d2 = hashmap.gather_candidates(
                m, world, voxel_size, max_probes, exact_prune_candidates,
                return_skip_bound=True)
            t, dist = hashmap.nn_from_candidates(cand, world, source_mask,
                                                 voxel_size)
            # Certificate: the pruned search equals the full search unless
            # some skipped box's lower bound reaches min(d*, tau)^2 (a
            # winner past tau is gated out either way).  The selection key
            # masks the 10 low mantissa bits of d^2 and breaks ties by
            # (offset id, lane), so the threshold is raised to the top of
            # the NEXT 10-bit bucket (which also absorbs the sqrt round
            # trip); the comparison stays in float32.
            d_cap = torch.minimum(dist, tau)
            d2 = torch.minimum(d_cap * d_cap, tau2)
            thresh = ((d2.to(torch.float32).view(torch.int32) | 0x3FF)
                      + 0x400).view(torch.float32)
            viol = (source_mask & (skip_lb_d2 <= thresh)).any(-1)
            return t, source_mask & (dist < tau), viol

        *solved, fallback = run_gn(associate_pruned, source, guess, **loop)
        passes = solved[1].clone()
        pose, iters, ncorr = fall_back_where(fallback, *solved)
        return pose, RegistrationDebug(iterations=iters,
                                       num_correspondences=ncorr,
                                       exact_fallback=fallback,
                                       solve_iterations=passes)

    pose, iters, ncorr = full_loop()
    return pose, RegistrationDebug(iterations=iters, num_correspondences=ncorr)


def _point_error(pose, guess, max_range: float):
    """The kernel's point-space odometry error of guess^-1 @ pose, float32
    (rotations preserve norms; trace(Rg^T R) is the Frobenius product)."""
    dt = torch.linalg.vector_norm(pose[..., :3, 3] - guess[..., :3, 3],
                                  dim=-1)
    frob = torch.sum(pose[..., :3, :3] * guess[..., :3, :3], dim=(-2, -1))
    c = torch.clamp((frob - 1.0) * 0.5, -1.0, 1.0)
    return (dt + 2.0 * max_range * torch.sqrt(
        torch.clamp((1.0 - c) * 0.5, min=0.0))).to(torch.float32)
