"""The plain reference that decides `correct`: coarse-to-fine photometric
Gauss-Newton and trust-region Levenberg-Marquardt of one frame pair, in
plain PyTorch, batched over independent pairs.

It is a frozen copy of the exact per-pair math of the reference
implementation (MiguelAlgaba/photoconsistency-visual-odometry, as
phovo_tpu_torch's plain versions write it): level k of a pyramid is the
original frame resized by 1/2^k (cv::resize INTER_LINEAR), Scharr
gradients with reflect-101 borders scaled per level, the source back-
projected through its depth, the target intensity and its gradients
sampled at each warped pixel (nearest or bilinear), and per level the
backend's solver, benchmark/reference/<backend>.py, found by the
configuration's backend name: analytic.py (Gauss-Newton steps until the
gradient norm falls under its threshold or the budget is spent) and
ceres.py (Ceres's trust-region loop with its tolerances). A preset value
the reference does not implement raises (`solver`). Every pair starts
from the state it is given (zero unless the harness's answer started
elsewhere) and aligns its source to its target, coarse to fine. It reads only the uint8 and uint16 frames the
harness hands the program, and builds its own pyramids and packs; it
imports nothing of the program.

`pack_dtype` is the control's knob: bfloat16 rounds every per-frame pack
(source intensity, back-projected geometry, target intensity and
gradients) to bfloat16 before the float32 arithmetic, the step that would
halve a level kernel's bytes.
"""

from __future__ import annotations

import importlib
import math
import re
from pathlib import Path

import numpy as np
import torch

# pairs x pixels a level advances at once: the per-pixel rows of a block
# (~30 float32 arrays of that size) take a few GB
PIXEL_PAIRS = 2**25
FRAME_BLOCK = 128  # pairs whose full-size frames are converted at once


def unit_intensity(i8: torch.Tensor) -> torch.Tensor:
    return i8.to(torch.float32) * (1.0 / 255.0)


def metres(d16: torch.Tensor, depth_scale: float) -> torch.Tensor:
    return d16.to(torch.float32) * float(np.float32(depth_scale))


def level_shape(shape, level):
    f = 1.0 / (2.0**level)
    return int(round(shape[0] * f)), int(round(shape[1] * f))


def _resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) OpenCV INTER_LINEAR operator along one axis."""
    A = torch.zeros((n_out, n_in), dtype=torch.float32)
    scale = n_in / n_out
    for d in range(n_out):
        s = (d + 0.5) * scale - 0.5
        s0 = math.floor(s)
        w1 = s - s0
        A[d, min(max(s0, 0), n_in - 1)] += 1.0 - w1
        A[d, min(max(s0 + 1, 0), n_in - 1)] += w1
    return A.to(device)


def resize(img: torch.Tensor, out_shape) -> torch.Tensor:
    """(..., H, W) -> (..., H', W'), INTER_LINEAR. An exact 1/2^k step is
    the mean of two neighbours at stride 2^k; other sizes go through the
    banded operators."""
    H, W = img.shape[-2:]
    Ho, Wo = out_shape
    if (H, W) == (Ho, Wo):
        return img
    if H % Ho == 0 and W % Wo == 0 and H // Ho == W // Wo and (H // Ho) & (H // Ho - 1) == 0:
        s = H // Ho
        off = s // 2 - 1
        rows = 0.5 * (img[..., off::s, :][..., :Ho, :] + img[..., off + 1::s, :][..., :Ho, :])
        return 0.5 * (rows[..., off::s][..., :Wo] + rows[..., off + 1::s][..., :Wo])
    return _resize_matrix(H, Ho, img.device) @ img @ _resize_matrix(W, Wo, img.device).T


def scharr(img: torch.Tensor, axis: str, scale: float) -> torch.Tensor:
    """Scharr d/dcol ('x') or d/drow ('y') with reflect-101 borders, times
    scale: a [3, 10, 3] smoothing across and [-1, 0, 1] along."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    x = img.reshape(-1, 1, H, W)
    smooth, deriv = (3.0, 10.0, 3.0), (-1.0, 0.0, 1.0)
    kr, kc = (smooth, deriv) if axis == "x" else (deriv, smooth)
    p = torch.nn.functional.pad(x, (0, 0, 1, 1), mode="reflect")
    out = sum(kr[t] * p[..., t:t + H, :] for t in range(3))
    p = torch.nn.functional.pad(out, (1, 1, 0, 0), mode="reflect")
    out = sum(kc[t] * p[..., t:t + W] for t in range(3))
    return out.reshape(*lead, H, W) * float(np.float32(scale))


def frame_packs(intensity, depth, intr, preset, level, pack_dtype=torch.float32):
    """One level's packs of F frames: (i0 (F, N), geom (F, 4, N) rows px, py,
    pz, depth in range, target (F, 3, N) rows I, gx, gy)."""
    H, W = level_shape(intensity.shape[-2:], level)
    img = resize(intensity, (H, W))
    d = resize(depth, (H, W))
    s = preset["gradient_scales"][level]
    gx, gy = scharr(img, "x", s), scharr(img, "y", s)
    fx, fy, cx, cy = (v / 2.0**level for v in intr)
    c = torch.arange(W, dtype=torch.float32, device=d.device)
    r = torch.arange(H, dtype=torch.float32, device=d.device)
    rr, cc = torch.meshgrid(r, c, indexing="ij")
    px = (cc - cx) * d / fx
    py = (rr - cy) * d / fy
    valid = ((d > preset["min_depth"]) & (d < preset["max_depth"])).to(torch.float32)
    F = img.shape[0]
    geom = torch.stack([px, py, d, valid], dim=1).reshape(F, 4, H * W)
    target = torch.stack([img, gx, gy], dim=1).reshape(F, 3, H * W)
    packs = (img.reshape(F, H * W), geom, target)
    if pack_dtype != torch.float32:
        packs = tuple(p.to(pack_dtype).to(torch.float32) for p in packs)
    return packs


def _rotation(s3, s4, s5):
    cy, sy = torch.cos(s3), torch.sin(s3)
    cp, sp = torch.cos(s4), torch.sin(s4)
    cr, sr = torch.cos(s5), torch.sin(s5)
    R = (cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
         sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
         -sp, cp * sr, cp * cr)
    dY = (-sy * cp, -sy * sp * sr - cy * cr, -sy * sp * cr + cy * sr,
          cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr)
    dP = (-cy * sp, cy * cp * sr, cy * cp * cr,
          -sy * sp, sy * cp * sr, sy * cp * cr,
          -cp, -sp * sr, -sp * cr)
    dR = (cy * sp * cr + sy * sr, -cy * sp * sr + sy * cr,
          sy * sp * cr - cy * sr, -sy * sp * sr - cy * cr,
          cp * cr, -cp * sr)
    return R, dY, dP, dR


def linearize(state, i0, geom, target, intr_l, H, W, bilinear):
    """Normal equations of B pairs at their states (B, 6): (JtJ (B, 6, 6),
    Jtr (B, 6), cost sum r^2 (B,), valid pixels (B,)). The residual is the
    target sampled at the warped source pixel minus the source intensity,
    the Jacobian the sampled target gradient through the projection and
    the ZYX rotation."""
    fx, fy, cx, cy = intr_l
    s = [state[:, k:k + 1] for k in range(6)]
    px, py, pz, vd = geom.unbind(1)
    (R00, R01, R02, R10, R11, R12, R20, R21, R22), dY, dP, dR = _rotation(s[3], s[4], s[5])
    tx = R00 * px + R01 * py + R02 * pz + s[0]
    ty = R10 * px + R11 * py + R12 * pz + s[1]
    tz = R20 * px + R21 * py + R22 * pz + s[2]
    iz = 1.0 / torch.where(tz.abs() > 1e-12, tz, torch.full_like(tz, 1e-12))
    u = tx * fx * iz + cx
    v = ty * fy * iz + cy
    valid = (vd > 0.5) & (tz > 0)
    ry0 = dY[0] * px + dY[1] * py + dY[2] * pz
    ry1 = dY[3] * px + dY[4] * py + dY[5] * pz
    rp0 = dP[0] * px + dP[1] * py + dP[2] * pz
    rp1 = dP[3] * px + dP[4] * py + dP[5] * pz
    rp2 = dP[6] * px + dP[7] * py + dP[8] * pz
    rr0 = dR[0] * py + dR[1] * pz
    rr1 = dR[2] * py + dR[3] * pz
    rr2 = dR[4] * py + dR[5] * pz
    a0, a2 = fx * iz, -fx * tx * iz * iz
    b1, b2 = fy * iz, -fy * ty * iz * iz

    def index(rows, cols):
        ri = rows.clamp(0, H - 1).to(torch.int64).clamp_(0, H - 1)
        ci = cols.clamp(0, W - 1).to(torch.int64).clamp_(0, W - 1)
        return ri * W + ci

    def sample(idx):
        return torch.gather(target, 2, idx.unsqueeze(1).expand(-1, 3, -1))

    if bilinear:
        c0, r0 = torch.floor(u), torch.floor(v)
        fc, fr = (u - c0).unsqueeze(1), (v - r0).unsqueeze(1)
        valid = valid & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        top = sample(index(r0, c0)) * (1 - fc) + sample(index(r0, c0 + 1)) * fc
        bot = sample(index(r0 + 1, c0)) * (1 - fc) + sample(index(r0 + 1, c0 + 1)) * fc
        samp = top * (1 - fr) + bot * fr
    else:
        c0, r0 = torch.round(u), torch.round(v)
        valid = valid & (c0 >= 0) & (c0 <= W - 1) & (r0 >= 0) & (r0 <= H - 1)
        samp = sample(index(r0, c0))
    i1w, gxw, gyw = samp.unbind(1)
    vf = valid.to(torch.float32)
    r = (i1w - i0) * vf
    J = torch.stack([
        gxw * a0 * vf,
        gyw * b1 * vf,
        (gxw * a2 + gyw * b2) * vf,
        (gxw * (a0 * ry0) + gyw * (b1 * ry1)) * vf,
        (gxw * (a0 * rp0 + a2 * rp2) + gyw * (b1 * rp1 + b2 * rp2)) * vf,
        (gxw * (a0 * rr0 + a2 * rr2) + gyw * (b1 * rr1 + b2 * rr2)) * vf,
    ], dim=1)
    JtJ = torch.bmm(J, J.transpose(1, 2))
    Jtr = torch.bmm(J, r.unsqueeze(2)).squeeze(2)
    return JtJ, Jtr, (r * r).sum(1), vf.sum(1)


def chol_solve6(A, b):
    """Unrolled 6x6 Cholesky solve of A x = b over a batch ((B, 6, 6),
    (B, 6) -> (B, 6)) in float32, pivots floored at 1e-30 with reciprocal
    square roots: the level kernels' solve, so a step rounds as theirs
    does; a non-finite solution stays non-finite."""
    L = [[None] * 6 for _ in range(6)]
    inv_d = [None] * 6
    for i in range(6):
        acc = A[:, i, i]
        for k in range(i):
            acc = acc - L[i][k] * L[i][k]
        acc = torch.clamp(acc, min=1e-30)
        inv_d[i] = torch.rsqrt(acc)
        L[i][i] = acc * inv_d[i]
        for j in range(i + 1, 6):
            acc = A[:, j, i]
            for k in range(i):
                acc = acc - L[j][k] * L[i][k]
            L[j][i] = acc * inv_d[i]
    y = [None] * 6
    for i in range(6):
        acc = b[:, i]
        for k in range(i):
            acc = acc - L[i][k] * y[k]
        y[i] = acc * inv_d[i]
    x = [None] * 6
    for i in range(5, -1, -1):
        acc = y[i]
        for k in range(i + 1, 6):
            acc = acc - L[k][i] * x[k]
        x[i] = acc * inv_d[i]
    return torch.stack(x, dim=1)


def dot6(a, b):
    acc = a[:, 0] * b[:, 0]
    for k in range(1, 6):
        acc = acc + a[:, k] * b[:, k]
    return acc


def align_pairs(src_i8, src_d16, tgt_i8, tgt_d16, cfg: dict, device, pack_dtype=torch.float32, inits=None):
    """Align P pairs (numpy (P, H, W) uint8 intensities and uint16 depth
    counts, source and target) from `inits` ((P, 6) float32 states; zero
    where None), coarse to fine, on `device`. cfg
    holds "backend", "preset" (the configuration file's), "intrinsics" and
    "depth_scale". Level by level, all pairs advance in blocks of at
    most PIXEL_PAIRS pixels. Returns numpy (states (P, 6) float32,
    iterations (P, L) int64, num_valid (P, L) float32); a level with no
    budget reports 0 iterations and 0 valid."""
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        frames = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (src_i8, src_d16, tgt_i8, tgt_d16)]
        return _align_levels(*frames, cfg, pack_dtype, inits)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


def _level_packs(si8, sd16, ti8, cfg, level, pack_dtype):
    """(i0, geom, target) of one level for a block of pairs, built from
    the full-size frames FRAME_BLOCK pairs at a time."""
    parts = []
    for lo in range(0, si8.shape[0], FRAME_BLOCK):
        sl = slice(lo, lo + FRAME_BLOCK)
        sd = metres(sd16[sl], cfg["depth_scale"])
        i0, geom, _ = frame_packs(unit_intensity(si8[sl]), sd, cfg["intrinsics"], cfg["preset"], level, pack_dtype)
        _, _, target = frame_packs(unit_intensity(ti8[sl]), sd, cfg["intrinsics"], cfg["preset"], level,
                                   pack_dtype)
        parts.append((i0, geom, target))
    return tuple(torch.cat(x) for x in zip(*parts))


# preset keys every solver reads
COMMON_KEYS = ("num_levels", "gradient_scales", "max_iterations", "min_depth", "max_depth", "sampling")
# preset keys that leave a pair's answer as it is: drawing, threads and
# logging, the TPU kernels' matmul precision (the program computes in
# float32 whatever it says), and the blur's kind and the robust loss's
# scale, which ONE_VALUE's no blur and no loss leave unread
NO_EFFECT = ("visualize_iterations", "num_threads", "num_linear_solver_threads", "progress_to_stdout", "mix_mode",
             "blur_type", "robust_delta")
# preset keys the reference implements at one value only: no blur,
# gradients at the warped target, no robust loss
ONE_VALUE = {
    "blur_filter_sizes": lambda v: all(int(b) == 0 for b in v),
    "gradient_at": lambda v: v == "warped",
    "robust_loss": lambda v: v == "none",
}


def solver(cfg: dict):
    """The level solver of cfg["backend"], benchmark/reference/<backend>.py,
    once every preset value of cfg is one the reference implements: a
    configuration it cannot follow raises here, and is never judged as if
    the program were at fault."""
    backend = cfg["backend"]
    module = None
    if re.fullmatch(r"[a-z][A-Za-z0-9_]*", backend) and Path(__file__).with_name(f"{backend}.py").is_file():
        module = importlib.import_module(f"benchmark.reference.{backend}")
    if not hasattr(module, "solve_level"):
        raise ValueError(f"the reference has no solver for backend {backend!r}")
    for key, value in cfg["preset"].items():
        if key in COMMON_KEYS or key in module.KEYS:  # a solver that reads a key implements its values
            continue
        if key in ONE_VALUE:
            if not ONE_VALUE[key](value):
                raise ValueError(f"the reference does not implement {key} = {value!r} ({backend})")
        elif key not in NO_EFFECT:
            raise ValueError(f"the reference does not implement the preset key {key!r} ({backend})")
    missing = [k for k in COMMON_KEYS + tuple(module.KEYS) if k not in cfg["preset"]]
    if missing:
        raise ValueError(f"the configuration leaves out {missing}, which the reference reads ({backend})")
    if cfg["preset"]["sampling"] not in module.SAMPLING:
        raise ValueError(f"the {backend} reference samples {module.SAMPLING}, not {cfg['preset']['sampling']!r}")
    return module


def _align_levels(si8, sd16, ti8, td16, cfg, pack_dtype, inits):
    del td16  # the target's depth is not read (the reference's SetTargetFrame ignores it)
    module = solver(cfg)
    pre = cfg["preset"]
    L = pre["num_levels"]
    P = si8.shape[0]
    dev = si8.device
    state = torch.zeros((P, 6), dtype=torch.float32, device=dev)
    if inits is not None:
        state.copy_(torch.from_numpy(np.asarray(inits, np.float32).reshape(P, 6)))
    its = torch.zeros((P, L), dtype=torch.int64, device=dev)
    nvs = torch.zeros((P, L), dtype=torch.float32, device=dev)
    for level in range(L - 1, -1, -1):
        if pre["max_iterations"][level] <= 0:
            continue
        H, W = level_shape(si8.shape[-2:], level)
        intr_l = tuple(v / 2.0**level for v in cfg["intrinsics"])
        block = max(1, PIXEL_PAIRS // (H * W))
        for lo in range(0, P, block):
            sl = slice(lo, lo + block)
            packs = _level_packs(si8[sl], sd16[sl], ti8[sl], cfg, level, pack_dtype)
            state[sl], its[sl, level], nvs[sl, level] = module.solve_level(state[sl], packs, intr_l, H, W, pre,
                                                                           level)
    return state.cpu().numpy(), its.cpu().numpy(), nvs.cpu().numpy()


def pose_matrix(state) -> np.ndarray:
    """(6,) [x, y, z, yaw, pitch, roll] -> (4, 4) float64 rigid transform,
    R = Rz(yaw) Ry(pitch) Rx(roll)."""
    x, y, z, yaw, pitch, roll = (float(v) for v in state)
    cy, sy, cp, sp, cr, sr = math.cos(yaw), math.sin(yaw), math.cos(pitch), math.sin(pitch), math.cos(roll), math.sin(
        roll)
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr, x],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr, y],
        [-sp, cp * sr, cp * cr, z],
        [0.0, 0.0, 0.0, 1.0],
    ])


def integrate(states) -> np.ndarray:
    """(n, 6) relative states, pair k aligning frame k to frame k+1 ->
    (n, 4, 4) float64 global poses of frames 1..n: pose <- pose @ Rt^-1
    from the identity (the reference VO app's loop)."""
    pose = np.eye(4)
    out = np.empty((len(states), 4, 4))
    for k, s in enumerate(states):
        Rt = pose_matrix(s)
        inv = np.eye(4)
        inv[:3, :3] = Rt[:3, :3].T
        inv[:3, 3] = -Rt[:3, :3].T @ Rt[:3, 3]
        pose = pose @ inv
        out[k] = pose
    return out
