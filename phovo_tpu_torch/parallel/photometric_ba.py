"""Windowed and global PHOTOMETRIC bundle adjustment, the direct-method
back-end (torch port of phovo_tpu/parallel/photometric_ba.py, single
device).

Sparse landmarks are chosen at high-gradient pixels of their host
keyframe, each carrying its measured host intensity, and every (landmark,
keyframe) observation contributes

    r_I = I_i( pi_i(X_j) ) - I_host(u_j)            (photometric)
    r_z = z_i(X_j) - D_i( pi_i(X_j) )               (depth consistency)

with I_i, D_i sampled bilinearly from the keyframes' images. Poses and
landmarks are refined jointly by the Schur-complement Levenberg-Marquardt
of parallel/bundle_adjustment.py, dense or sparse W.

phovo_tpu runs this as XLA code with no Pallas kernel; the port runs it as
plain torch on the device of the keyframe images (the card unless the
caller puts them elsewhere). The sliding windows (refine_photometric_windows)
are one Python loop, each window built and solved on the device from the
device-resident keyframe stacks, its Schur path routed by size
(bundle_adjustment.schur_route 'auto'), chained through the overlap pose
as phovo_tpu's scan is. phovo_tpu pads shapes to reuse compiled XLA
programs; the port compiles nothing and pads nothing.

With a mesh (parallel/mesh.py) the keyframe images stay whole on every
rank and the observations are sharded over its ranks, flattened, the
blocks merged by one all_reduce a build (bundle_adjustment.merge_blocks),
for windows and global problems alike.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from phovo_tpu_torch.ops import se3
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.parallel import bundle_adjustment as ba


class PhotometricBAProblem(NamedTuple):
    """A photometric BA problem on one device. Observations with obs_pose
    -1 are padding and contribute exact zeros."""

    pose_states: torch.Tensor  # (M, 6) keyframe states (world <- keyframe)
    points: torch.Tensor  # (P, 3) world landmarks
    intensities: torch.Tensor  # (M, H, W) keyframe intensities (0..1)
    depths: torch.Tensor  # (M, H, W) keyframe depths (metres)
    ref_intensity: torch.Tensor  # (P,) measured host-frame intensity
    obs_pose: torch.Tensor  # (K,) keyframe index (-1 pad)
    obs_point: torch.Tensor  # (K,) landmark index
    weights: torch.Tensor  # (K,) photometric information weight
    z_weights: torch.Tensor  # (K,) depth information weight (0 = photo-only)
    # occlusion gate (metres): an observation whose predicted and measured
    # depths differ by more than this sees another surface, and both its
    # rows are dropped; inf disables
    occ_gate: float = np.inf


def _sample_stack(flat_imgs, base, col, row, H: int, W: int):
    """Bilinear samples of images base // (H W) of a flat (M H W,) stack at
    (col, row), one gather a corner; (values, in-bounds). Corner indices
    are clamped to the image, so a tap past the edge repeats the edge
    pixel (derivative 0)."""
    inb = (row >= 0.0) & (row < H) & (col >= 0.0) & (col < W)
    r0 = torch.floor(row)
    c0 = torch.floor(col)
    wr = row - r0
    wc = col - c0
    # clamped before the cast, which is undefined for huge floats (a point
    # far off the image; its rows are masked)
    r0i = torch.clamp(torch.clamp(r0, -1.0, float(H)).long(), 0, H - 1)
    c0i = torch.clamp(torch.clamp(c0, -1.0, float(W)).long(), 0, W - 1)
    r1i = torch.clamp(r0i + 1, 0, H - 1)
    c1i = torch.clamp(c0i + 1, 0, W - 1)
    v00 = flat_imgs[base + r0i * W + c0i]
    v01 = flat_imgs[base + r0i * W + c1i]
    v10 = flat_imgs[base + r1i * W + c0i]
    v11 = flat_imgs[base + r1i * W + c1i]
    top = v00 * (1.0 - wc) + v01 * wc
    bot = v10 * (1.0 - wc) + v11 * wc
    return top * (1.0 - wr) + bot * wr, inb


def _photo_residual(states, points, base, ref_i, flat_I, flat_D, intr, H: int, W: int, occ_gate=np.inf):
    """((K, 2) rows (r_I, r_z), (K,) valid) of K observations: the
    reference's projection (u = fx x / z + cx) through T =
    pose_matrix(state), world from keyframe. valid: in the image, in front
    of the camera, measured depth there, and |z - D_i| below occ_gate."""
    u, v, z = ba.pixel(ba.camera_point(states, points), intr)
    Ii, inb = _sample_stack(flat_I, base, u, v, H, W)
    Di, _ = _sample_stack(flat_D, base, u, v, H, W)
    valid = inb & (z > 1e-6) & (Di > 1e-6) & ((z - Di).abs() < occ_gate)
    return torch.stack([Ii - ref_i, z - Di], dim=-1), valid


def _linearize(problem: PhotometricBAProblem, intr: Intrinsics):
    """Per-observation residuals r (K, 2) and Jacobians A (K, 2, 6), B (K,
    2, 3), rows scaled by sqrt(weights) and zeroed where the projection
    leaves the image, the depth is invalid or the row is padding; and the
    gather indices iw, jw."""
    M, H, W = problem.intensities.shape
    flat_I = problem.intensities.reshape(-1)
    flat_D = problem.depths.reshape(-1)
    pvalid = problem.obs_pose >= 0
    iw = torch.where(pvalid, problem.obs_pose, 0).long()
    jw = torch.where(pvalid, problem.obs_point, 0).long()
    base = iw * (H * W)
    ref = problem.ref_intensity[jw]

    def residual(s, X):
        return _photo_residual(s, X, base, ref, flat_I, flat_D, intr, H, W, problem.occ_gate)

    r, A, B, valid = ba.observation_jacobians(residual, problem.pose_states[iw], problem.points[jw], has_aux=True)
    vf = (valid & pvalid).to(r.dtype)
    sw = torch.stack([torch.sqrt(problem.weights) * vf, torch.sqrt(problem.z_weights) * vf], dim=1)
    return r * sw, A * sw[:, :, None], B * sw[:, :, None], iw, jw


def _accumulate(problem, intr, M: int, Pn: int, robust_delta=None, sparse=False, robust_z_delta=None):
    """The blocks of one linearization. Huber IRLS per ROW, each in its own
    units: robust_delta on the photometric row (intensity), robust_z_delta
    on the depth row in METRES (its weighted residual divided back by
    sqrt(w_z)). A joint-norm Huber would push the (fx/z)-weighted depth
    inliers into the L1 regime (phovo_tpu's measurement)."""
    r, A, B, iw, jw = _linearize(problem, intr)
    if robust_delta is not None or robust_z_delta is not None:
        ones = torch.ones_like(r[:, 0])
        swI = ones if robust_delta is None else ba.huber_scale(r[:, 0].abs(), robust_delta)
        swZ = ones
        if robust_z_delta is not None:
            zw = torch.clamp(problem.z_weights, min=1e-12)
            swZ = ba.huber_scale(r[:, 1].abs() / torch.sqrt(zw), robust_z_delta)
        row = torch.stack([swI, swZ], dim=1)
        r, A, B = r * row, A * row[:, :, None], B * row[:, :, None]
    return ba.normal_blocks(r, A, B, iw, jw, M, Pn, sparse)


def optimize_photometric_bundle(
    problem: PhotometricBAProblem,
    intr: Intrinsics,
    mesh=None,
    iterations: int = 8,
    damping: float = 1e-4,
    fixed_first: bool = True,
    robust_delta: float | None = None,
    schur: str = "dense",
    robust_z_delta: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Joint photometric refinement of keyframe poses and landmarks on the
    problem's device (the builders put it on the card unless told
    otherwise). Returns (pose_states, points, cost).

    schur: 'dense' forms W (M, P, 6, 3); 'sparse' adds the Schur fill over
    the same-landmark pair list instead; 'auto' is dense where
    bundle_adjustment.dense_w_fits. robust_delta and robust_z_delta: the
    per-row Huber deltas of _accumulate. mesh (parallel/mesh.py): every
    rank calls with the same problem, its observations are split over the
    mesh's ranks and the blocks merged once an iteration; every rank
    returns the same result, a one-rank mesh the unsharded bits."""
    route = ba.schur_route(schur, int(problem.pose_states.shape[0]), int(problem.points.shape[0]))
    pair_a = pair_b = None
    if route == "sparse":
        pair_a, pair_b = ba.pair_tensors(problem.obs_pose, problem.obs_point, problem.pose_states.device)
    return _optimize_photometric_core(problem, intr, damping, pair_a, pair_b, iterations=iterations,
                                      fixed_first=fixed_first, robust_delta=robust_delta,
                                      robust_z_delta=robust_z_delta, mesh=mesh)


def _optimize_photometric_core(problem, intr, damping, pair_a, pair_b, *, iterations, fixed_first, robust_delta,
                               robust_z_delta=None, mesh=None):
    """The LM loop over a photometric problem; pair_a not None selects
    the sparse-W path; mesh shards the observations."""
    M, Pn, K = problem.pose_states.shape[0], problem.points.shape[0], problem.obs_pose.shape[0]
    sparse = pair_a is not None
    lo, hi = ba.observation_shard(mesh, K)
    shard = problem._replace(obs_pose=problem.obs_pose[lo:hi], obs_point=problem.obs_point[lo:hi],
                             weights=problem.weights[lo:hi], z_weights=problem.z_weights[lo:hi])

    def raw_build(states, points):
        blocks = _accumulate(shard._replace(pose_states=states, points=points), intr, M, Pn, robust_delta, sparse,
                             robust_z_delta)
        return ba.merge_blocks(mesh, blocks, sparse, K, lo)

    if sparse:
        build = ba.sparse_build(raw_build, problem.obs_pose, problem.obs_point)

        def step_fn(*a):
            return ba._schur_step_sparse(*a, pair_a=pair_a, pair_b=pair_b)
    else:
        build, step_fn = raw_build, ba._schur_step
    return ba._lm_iterate(build, problem.pose_states, problem.points, iterations, damping, fixed_first, step_fn)


# -- front-end ----------------------------------------------------------------


def select_landmark_pixels(intensity: np.ndarray, depth: np.ndarray, grid: int = 8,
                           min_depth: float = 0.05) -> np.ndarray:
    """One high-gradient pixel with valid depth per cell of a grid x grid
    tiling, off the outer 2-pixel rim (bilinear stencils stay inside).
    Returns (grid*grid, 2) int32 (row, col), -1 rows for cells with no
    gradient or no valid depth."""
    I = np.asarray(intensity, np.float32)
    D = np.asarray(depth, np.float32)
    H, W = I.shape
    gy, gx = np.gradient(I)
    mag = gx * gx + gy * gy
    mag[D <= min_depth] = -1.0
    mag[:2, :] = -1.0
    mag[-2:, :] = -1.0
    mag[:, :2] = -1.0
    mag[:, -2:] = -1.0
    hs, ws = H // grid, W // grid
    out = np.full((grid * grid, 2), -1, np.int32)
    if hs > 0 and ws > 0:
        # one argmax per cell over the (grid, grid, hs, ws) cell view
        cells = mag[:grid * hs, :grid * ws].reshape(grid, hs, grid, ws).transpose(0, 2, 1, 3).reshape(
            grid * grid, hs * ws)
        flat = cells.argmax(axis=1)
        best = cells[np.arange(grid * grid), flat]
        rows = flat // ws + np.repeat(np.arange(grid), grid) * hs
        cols = flat % ws + np.tile(np.arange(grid), grid) * ws
        good = best > 0.0
        out[good, 0] = rows[good]
        out[good, 1] = cols[good]
    return out


def window_starts(M: int, window: int) -> list[int]:
    """Sliding-window starts over M keyframes: stride window - 1 (each
    window overlaps its predecessor by one keyframe, anchored on the
    already-refined estimate), plus a tail window slid back to cover the
    rest."""
    window = max(2, min(window, M))
    starts = list(range(0, M - window + 1, window - 1))
    if not starts:
        starts = [0]
    if starts[-1] + window < M:
        starts.append(M - window)
    return starts


def _host_landmarks(intensity, depth, T, grid, fx, fy, cx, cy):
    """One keyframe's grid*grid landmark slots backprojected through its
    depth and pose in float64: (points (G, 3), host intensities (G,),
    valid (G,))."""
    sel = select_landmark_pixels(intensity, depth, grid=grid)
    G = grid * grid
    pts, ref, ok = np.zeros((G, 3), np.float32), np.zeros(G, np.float32), np.zeros(G, bool)
    for k, (r, c) in enumerate(sel):
        if r >= 0:
            z = float(depth[r, c])
            pts[k] = (T @ np.array([(c - cx) * z / fx, (r - cy) * z / fy, z, 1.0]))[:3]
            ref[k] = float(intensity[r, c])
            ok[k] = True
    return pts, ref, ok


def _depth_weight(depths: np.ndarray, fx: float, depth_weight_scale: float) -> float:
    """The (fx / mean depth)^2 pixel-equivalent weight of the depth rows."""
    pos = depths[depths > 0]
    mean_z = float(pos.mean()) if pos.size else 1.0
    return depth_weight_scale * (fx / max(mean_z, 0.1)) ** 2


def build_photometric_global(
    intensities: np.ndarray,
    depths: np.ndarray,
    pose_states: np.ndarray,
    intr: Intrinsics,
    grid: int = 8,
    max_covis: int = 6,
    photo_weight: float = 1.0,
    depth_weight_scale: float = 1.0,
    occ_gate: float = np.inf,
    device_intensities: torch.Tensor | None = None,
    device_depths: torch.Tensor | None = None,
    device=None,
) -> PhotometricBAProblem:
    """ONE photometric BA problem over ALL M keyframes (the map-scale
    scope). Each landmark is observed in at most max_covis keyframes, the
    nearest to its host by camera centre (the host excluded; rows whose
    projection leaves the frame gate themselves), so K = M grid^2 max_covis
    stays O(M) while the dense W grows as M^2 grid^2, and past the budget
    schur='auto' takes the sparse path.

    intensities, depths (M, H, W) and pose_states (M, 6) are host arrays
    (landmark selection runs on the host; uint8 intensities are divided by
    255). device_intensities, device_depths: the same images already on
    the device (float 0..1, metres), used instead of uploading the host
    arrays. The problem lives on their device, else on `device`, else on
    the CUDA card (a missing card raises RuntimeError)."""
    intensities = np.asarray(intensities)
    if intensities.dtype == np.uint8:
        intensities = intensities.astype(np.float32) / 255.0
    depths = np.asarray(depths, np.float32)
    pose_states = np.asarray(pose_states, np.float32)
    M, H, W = intensities.shape
    if M < 2:
        raise ValueError("global BA needs at least 2 keyframes")
    dev = ba.resolve_device(device, device_intensities)
    max_covis = max(1, min(max_covis, M - 1))
    fx, fy, cx, cy = (float(v) for v in intr)
    G = grid * grid
    Pn = M * G
    Ts = [se3.pose_matrix_np(pose_states[m]) for m in range(M)]
    centers = np.stack([T[:3, 3] for T in Ts])
    lms = [_host_landmarks(intensities[m], depths[m], Ts[m], grid, fx, fy, cx, cy) for m in range(M)]
    pts, ref_i, valid_lm = (np.concatenate(x) for x in zip(*lms))
    if not valid_lm.any():
        raise ValueError("no valid landmarks found")
    # the nearest keyframes of each HOST, shared by its G landmarks
    d2 = np.sum((centers[:, None, :] - centers[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    near = np.argsort(d2, axis=1)[:, :max_covis].astype(np.int32)  # (M, C)
    obs_pose = np.where(valid_lm[:, None], np.repeat(near, G, axis=0), -1).reshape(-1)
    obs_point = np.repeat(np.arange(Pn, dtype=np.int32), max_covis)
    zw = _depth_weight(depths, fx, depth_weight_scale)
    dev_I = device_intensities if device_intensities is not None else torch.from_numpy(
        np.asarray(intensities, np.float32)).to(dev)
    dev_D = device_depths if device_depths is not None else torch.from_numpy(depths).to(dev)
    K = obs_pose.shape[0]
    return PhotometricBAProblem(
        pose_states=torch.from_numpy(pose_states).to(dev),
        points=torch.from_numpy(pts).to(dev),
        intensities=dev_I,
        depths=dev_D,
        ref_intensity=torch.from_numpy(ref_i).to(dev),
        obs_pose=torch.from_numpy(obs_pose).to(dev, torch.int64),
        obs_point=torch.from_numpy(obs_point).to(dev, torch.int64),
        weights=torch.full((K,), photo_weight, dtype=torch.float32, device=dev),
        z_weights=torch.full((K,), zw, dtype=torch.float32, device=dev),
        occ_gate=float(np.float32(occ_gate)),
    )


def build_photometric_window(
    intensities: np.ndarray,
    depths: np.ndarray,
    pose_states: np.ndarray,
    intr: Intrinsics,
    grid: int = 8,
    photo_weight: float = 1.0,
    depth_weight_scale: float = 1.0,
    occ_gate: float = np.inf,
    device=None,
) -> PhotometricBAProblem:
    """A photometric BA window of M keyframes, built on the host: grid^2
    landmark slots a keyframe, backprojected through the host keyframe's
    depth and CURRENT pose into world coordinates, each carrying its host
    pixel's intensity; every landmark observed by every keyframe EXCEPT its
    host (the host row is zero at the linearization point); invalid slots
    are padding rows (obs_pose -1). Depth rows get the (fx/z)^2
    pixel-equivalent weight. The problem goes to `device` (the CUDA card
    unless named; a missing card raises RuntimeError)."""
    intensities = np.asarray(intensities, np.float32)
    depths = np.asarray(depths, np.float32)
    pose_states = np.asarray(pose_states, np.float32)
    M, H, W = intensities.shape
    dev = ba.resolve_device(device)
    fx, fy, cx, cy = (float(v) for v in intr)
    G = grid * grid
    lms = [_host_landmarks(intensities[m], depths[m], se3.pose_matrix_np(pose_states[m]), grid, fx, fy, cx, cy)
           for m in range(M)]
    pts, ref_i, valid_lm = (np.concatenate(x) for x in zip(*lms))
    if not valid_lm.any():
        raise ValueError("no valid landmarks found in the window")
    others = np.asarray([[i for i in range(M) if i != m] for m in range(M)], np.int32).reshape(M, M - 1)
    obs_pose = np.where(valid_lm[:, None], np.repeat(others, G, axis=0), -1).reshape(-1)
    obs_point = np.repeat(np.arange(M * G, dtype=np.int32), M - 1)
    zw = _depth_weight(depths, fx, depth_weight_scale)
    K = obs_pose.shape[0]
    return PhotometricBAProblem(
        pose_states=torch.from_numpy(pose_states).to(dev),
        points=torch.from_numpy(pts).to(dev),
        intensities=torch.from_numpy(intensities).to(dev),
        depths=torch.from_numpy(depths).to(dev),
        ref_intensity=torch.from_numpy(ref_i).to(dev),
        obs_pose=torch.from_numpy(obs_pose).to(dev, torch.int64),
        obs_point=torch.from_numpy(obs_point).to(dev, torch.int64),
        weights=torch.full((K,), photo_weight, dtype=torch.float32, device=dev),
        z_weights=torch.full((K,), zw, dtype=torch.float32, device=dev),
        occ_gate=float(np.float32(occ_gate)),
    )


def build_window_problem_device(
    kf_intensities: torch.Tensor,
    kf_depths: torch.Tensor,
    states_w: torch.Tensor,
    sel: torch.Tensor,
    start: int,
    intr: Intrinsics,
    *,
    window: int,
    grid: int,
    photo_weight: float = 1.0,
    depth_weight_scale: float = 1.0,
    occ_gate: float = np.inf,
) -> tuple[PhotometricBAProblem, torch.Tensor]:
    """build_photometric_window on the device for the contiguous window
    [start, start + window) of the keyframe stacks (M, H, W): landmarks
    backprojected in float32 from the precomputed selection pixels sel (M,
    grid^2, 2) through the CURRENT window states (window, 6), the host
    builder's every-other-member observation table. Returns (problem,
    landmark-valid mask (P,)). The host builder works in float64, so the
    two agree to input rounding (~2e-7)."""
    dev = kf_intensities.device
    Wn, G = window, grid * grid
    Pn = Wn * G
    I_w = kf_intensities[start:start + Wn]
    D_w = kf_depths[start:start + Wn]
    sel_w = sel[start:start + Wn].long()
    others = np.asarray([[i for i in range(Wn) if i != m] for m in range(Wn)], np.int64).reshape(Wn, Wn - 1)
    obs_pose_full = torch.from_numpy(np.repeat(others, G, axis=0)).to(dev)  # (Pn, Wn - 1)
    r, c = sel_w[..., 0], sel_w[..., 1]
    valid_lm = r >= 0  # (Wn, G)
    rs, cs = torch.clamp(r, min=0), torch.clamp(c, min=0)
    midx = torch.arange(Wn, device=dev)[:, None]
    z = D_w[midx, rs, cs]
    ref = I_w[midx, rs, cs]
    pc = torch.stack([(cs.to(torch.float32) - intr.cx) * z / intr.fx,
                      (rs.to(torch.float32) - intr.cy) * z / intr.fy, z], dim=-1)  # (Wn, G, 3)
    T = se3.pose_matrix(states_w)  # (Wn, 4, 4)
    pw = torch.einsum("mij,mgj->mgi", T[:, :3, :3], pc) + T[:, None, :3, 3]
    pts = torch.where(valid_lm[..., None], pw, torch.zeros_like(pw)).reshape(Pn, 3)
    ref_i = torch.where(valid_lm, ref, torch.zeros_like(ref)).reshape(Pn)
    lm_v = valid_lm.reshape(Pn)
    obs_pose = torch.where(lm_v[:, None], obs_pose_full, -1).reshape(-1)
    obs_point = torch.arange(Pn, device=dev).repeat_interleave(Wn - 1)
    pos = (D_w > 0).to(torch.float32)
    mean_z = torch.sum(D_w * pos) / torch.clamp(torch.sum(pos), min=1.0)
    fx = torch.tensor(intr.fx, dtype=torch.float32, device=dev)
    zw = depth_weight_scale * (fx / torch.clamp(mean_z, min=0.1)) ** 2
    K = obs_pose.shape[0]
    problem = PhotometricBAProblem(
        pose_states=states_w,
        points=pts,
        intensities=I_w,
        depths=D_w,
        ref_intensity=ref_i,
        obs_pose=obs_pose,
        obs_point=obs_point,
        weights=torch.full((K,), photo_weight, dtype=torch.float32, device=dev),
        z_weights=zw.expand(K),
        occ_gate=float(np.float32(occ_gate)),
    )
    return problem, lm_v


def refine_photometric_windows(
    kf_intensities: torch.Tensor,
    kf_depths: torch.Tensor,
    states0: torch.Tensor,
    sel: torch.Tensor,
    starts,
    intr: Intrinsics,
    damping: float,
    *,
    window: int,
    grid: int,
    iterations: int,
    robust_delta: float | None,
    photo_weight: float = 1.0,
    depth_weight_scale: float = 1.0,
    occ_gate: float = np.inf,
    robust_z_delta: float | None = None,
    mesh=None,
):
    """Every sliding-window photometric BA over the device-resident
    keyframe stacks kf_intensities (M, H, W, float 0..1), kf_depths (M, H,
    W, metres), on their device: window by window (phovo_tpu's lax.scan),
    each window built on the device from the CURRENT states
    (build_window_problem_device) and refined by optimize_photometric_bundle
    with schur='auto' (the sparse path where a window's dense W would not
    fit DENSE_W_BUDGET_BYTES) over `mesh`, its refined poses written back,
    so the next window's overlap pose is the refined one. starts is read
    once on the host.

    Returns (states (M, 6), points (Nw, P, 3), ref_i (Nw, P), lm_valid
    (Nw, P) bool): each window's refined landmarks, for the map."""
    starts = [int(s) for s in torch.as_tensor(starts).tolist()]
    states = torch.as_tensor(states0, dtype=torch.float32, device=kf_intensities.device).clone()
    points, refs, lm_valid = [], [], []
    for s in starts:
        st_w = states[s:s + window].clone()
        problem, lm_v = build_window_problem_device(
            kf_intensities, kf_depths, st_w, sel, s, intr, window=window, grid=grid, photo_weight=photo_weight,
            depth_weight_scale=depth_weight_scale, occ_gate=occ_gate,
        )
        refined, pts, _ = optimize_photometric_bundle(problem, intr, mesh=mesh, iterations=iterations,
                                                      damping=damping, fixed_first=True, robust_delta=robust_delta,
                                                      schur="auto", robust_z_delta=robust_z_delta)
        states[s:s + window] = refined
        points.append(pts)
        refs.append(problem.ref_intensity)
        lm_valid.append(lm_v)
    return states, torch.stack(points), torch.stack(refs), torch.stack(lm_valid)
