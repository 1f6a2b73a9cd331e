"""Synthetic RGB-D frames with exact ground-truth pose (numpy; a jax-free
copy of the generators of phovo_tpu/utils/synthetic.py).

An analytically textured slanted plane (render_plane), a cluttered scene
(render_cluttered: floating rectangles before a plane, with occlusions;
degrade_frame adds sensor noise, holes and exposure drift) or a room
interior (render_room: five non-parallel walls and two slabs) is rendered
from known camera poses, so alignment must recover a KNOWN state. The
renderers are phovo_tpu's numpy code: the same pose (and generator state)
gives the same bits. Poses here
are computed in float64 (phovo_tpu rounds them through float32), so
trajectories from the two packages agree to about 1e-7; tests feed both
packages the same arrays.
"""

from __future__ import annotations

import numpy as np

from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.se3 import pose_matrix_np


def _texture(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Smooth, non-periodic-looking intensity in [0, 1] over plane coords."""
    v = (
        0.5
        + 0.18 * np.sin(3.1 * x) * np.cos(2.3 * y)
        + 0.12 * np.sin(7.3 * x + 1.1)
        + 0.10 * np.cos(5.7 * y + 0.4)
        + 0.10 * np.sin(2.1 * (x + y))
    )
    return np.clip(v, 0.0, 1.0)


def render_plane(
    intr: Intrinsics,
    shape: tuple[int, int],
    T_cam_from_world: np.ndarray,
    plane_normal=(0.06, -0.04, 1.0),
    plane_d: float = 2.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Render float32 (intensity, depth) of the textured plane n.p = d
    (world frame) from a camera with pose T (world -> camera)."""
    H, W = shape
    fx, fy, cx, cy = (float(v) for v in intr)
    n = np.asarray(plane_normal, dtype=np.float64)
    R = np.asarray(T_cam_from_world, dtype=np.float64)[:3, :3]
    t = np.asarray(T_cam_from_world, dtype=np.float64)[:3, 3]
    # plane in the camera frame: (R n).p_c = d + (R n).t
    n_c = R @ n
    d_c = plane_d + n_c @ t
    cc, rr = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    vx = (cc - cx) / fx
    vy = (rr - cy) / fy
    z = d_c / np.maximum(n_c[0] * vx + n_c[1] * vy + n_c[2], 1e-9)
    pc = np.stack([vx * z, vy * z, z], axis=-1)
    pw = (pc - t) @ R  # R^T (p - t), row-wise
    return _texture(pw[..., 0], pw[..., 1]).astype(np.float32), z.astype(np.float32)


def render_cluttered(
    intr: Intrinsics,
    shape: tuple[int, int],
    T_cam_from_world: np.ndarray,
    objects: list[dict] | None = None,
    plane_normal=(0.06, -0.04, 1.0),
    plane_d: float = 2.6,
) -> tuple[np.ndarray, np.ndarray]:
    """Render a multi-object scene: background plane + floating textured
    rectangles at different depths, composited by nearest-hit along each
    pixel ray. Unlike render_plane, this produces depth DISCONTINUITIES and
    OCCLUSION (pixels visible in one frame and hidden in the next) — the
    photometric-violation regime real TUM sequences live in
    (PhotoconsistencyVisualOdometry.cpp:119-267 is built for such data).

    objects: list of dicts with keys normal (3,), d (plane offset), center
    (2,) in-plane xy, half_extent (2,), phase (texture offset). Defaults to
    a seeded 6-object arrangement.
    """
    H, W = shape
    fx, fy, cx, cy = (float(np.asarray(v)) for v in intr)
    R = np.asarray(T_cam_from_world, dtype=np.float64)[:3, :3]
    t = np.asarray(T_cam_from_world, dtype=np.float64)[:3, 3]

    if objects is None:
        objects = default_clutter(seed=1)

    c = np.arange(W, dtype=np.float64)
    r = np.arange(H, dtype=np.float64)
    cc, rr = np.meshgrid(c, r)
    vx = (cc - cx) / fx
    vy = (rr - cy) / fy

    def hit(normal, d):
        n = np.asarray(normal, dtype=np.float64)
        n_c = R @ n
        d_c = d + n_c @ t
        denom = n_c[0] * vx + n_c[1] * vy + n_c[2]
        with np.errstate(divide="ignore", invalid="ignore"):
            z = d_c / denom
        z = np.where((denom > 1e-9) & (z > 0.05), z, np.inf)
        pc = np.stack([vx * z, vy * z, z], axis=-1)
        pw = (pc - t) @ R  # world point, row-wise R^T (p - t)
        return z, pw

    # background plane
    z_best, pw = hit(plane_normal, plane_d)
    intensity = _texture(pw[..., 0], pw[..., 1])

    for k, obj in enumerate(objects):
        z, pw_o = hit(obj["normal"], obj["d"])
        inb = (
            (np.abs(pw_o[..., 0] - obj["center"][0]) < obj["half_extent"][0])
            & (np.abs(pw_o[..., 1] - obj["center"][1]) < obj["half_extent"][1])
        )
        z = np.where(inb, z, np.inf)
        closer = z < z_best
        tex = _texture(
            (pw_o[..., 0] + obj["phase"]) * (1.3 + 0.2 * k),
            (pw_o[..., 1] - obj["phase"]) * (1.1 + 0.15 * k),
        )
        intensity = np.where(closer, tex, intensity)
        z_best = np.where(closer, z, z_best)

    z_best = np.where(np.isfinite(z_best), z_best, 0.0)  # misses -> invalid depth
    return intensity.astype(np.float32), z_best.astype(np.float32)


def render_room(
    intr: Intrinsics,
    shape: tuple[int, int],
    T_cam_from_world: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Render float32 (intensity, depth) of a room interior from a camera
    with pose T (world -> camera): five mutually non-parallel textured
    planes (back wall, side walls, floor, ceiling) and two bounded slabs at
    intermediate depths, composited by nearest hit. Surfaces at many depths
    and orientations keep a photometric bundle adjustment well conditioned
    (a single plane constrains one translation direction strongly). The
    camera starts at the origin looking +z; surface depths 0.8-4.5 m; a
    ray that hits nothing has depth 0."""
    H, W = shape
    fx, fy, cx, cy = (float(v) for v in intr)
    R = np.asarray(T_cam_from_world, dtype=np.float64)[:3, :3]
    t = np.asarray(T_cam_from_world, dtype=np.float64)[:3, 3]
    cc, rr = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    vx = (cc - cx) / fx
    vy = (rr - cy) / fy

    def hit(normal, d):
        """Depth along the ray (vx, vy, 1) to the plane n.p = d (inf where
        it misses or lies behind) and the world-frame hit point; both signs
        of the denominator count (a left-wall ray has n_c.v < 0)."""
        n_c = R @ np.asarray(normal, dtype=np.float64)
        d_c = d + n_c @ t
        denom = n_c[0] * vx + n_c[1] * vy + n_c[2]
        with np.errstate(divide="ignore", invalid="ignore"):
            z = d_c / denom
        z = np.where((np.abs(denom) > 1e-9) & (z > 0.05), z, np.inf)
        z_s = np.where(np.isfinite(z), z, 0.0)  # keeps inf out of the texture
        pc = np.stack([vx * z_s, vy * z_s, z_s], axis=-1)
        return z, (pc - t) @ R  # R^T (p - t), row-wise

    # (normal, d, texture axes, frequency, phase): normals tilted off-axis
    # so no two surfaces are parallel
    surfaces = [
        ((0.02, -0.03, 1.0), 3.2, (0, 1), 1.0, 0.0),  # back wall
        ((1.0, 0.04, 0.05), -2.0, (2, 1), 1.35, 1.3),  # left wall
        ((1.0, -0.03, 0.06), 2.0, (2, 1), 0.8, 2.1),  # right wall
        ((0.03, 1.0, 0.04), 1.4, (0, 2), 1.15, 0.7),  # floor
        ((-0.02, 1.0, 0.03), -1.4, (0, 2), 0.9, 2.8),  # ceiling
    ]
    z_best = np.full((H, W), np.inf)
    intensity = np.zeros((H, W))
    for normal, d, (ua, va), freq, phase in surfaces:
        z, pw = hit(normal, d)
        closer = z < z_best
        tex = _texture(pw[..., ua] * freq + phase, pw[..., va] * freq - phase)
        intensity = np.where(closer, tex, intensity)
        z_best = np.where(closer, z, z_best)
    # bounded slabs: parallax at intermediate depths, and occlusion
    slabs = [
        dict(normal=(0.15, -0.1, 1.0), d=2.1, axes=(0, 1), center=(-0.7, 0.55), half=(0.45, 0.35), freq=1.9,
             phase=0.9),
        dict(normal=(0.9, 0.12, 0.45), d=1.15, axes=(2, 1), center=(1.45, 0.2), half=(0.5, 0.4), freq=1.6,
             phase=2.4),
    ]
    for s in slabs:
        z, pw = hit(s["normal"], s["d"])
        ua, va = s["axes"]
        inb = (np.abs(pw[..., ua] - s["center"][0]) < s["half"][0]) & (
            np.abs(pw[..., va] - s["center"][1]) < s["half"][1])
        z = np.where(inb, z, np.inf)
        closer = z < z_best
        tex = _texture(pw[..., ua] * s["freq"] + s["phase"], pw[..., va] * s["freq"] - s["phase"])
        intensity = np.where(closer, tex, intensity)
        z_best = np.where(closer, z, z_best)
    z_best = np.where(np.isfinite(z_best), z_best, 0.0)
    return intensity.astype(np.float32), z_best.astype(np.float32)


def forward_trajectory(n_frames: int, motion_scale: float = 1.0, seed: int = 0) -> list[np.ndarray]:
    """A one-way sweep (list of T_cam_from_world): steady translation and a
    slow turn, no revisits, so a keyframe back-end has odometry edges only.
    seed is unused (the signature of the other trajectories)."""
    per = motion_scale / max(n_frames, 1)
    return [
        pose_matrix_np(np.array([1.1 * per * k, -0.5 * per * k, 0.55 * per * k, 0.45 * per * k, -0.18 * per * k,
                                 0.3 * per * k]))
        for k in range(n_frames)
    ]


def loop_trajectory(n_frames: int, motion_scale: float = 1.0, seed: int = 0) -> list[np.ndarray]:
    """An out-and-back path (list of T_cam_from_world) that returns to the
    start, so the last keyframes close loops with the first. seed is
    unused."""
    half = n_frames // 2
    reach = 0.9 * motion_scale
    poses = []
    for k in range(n_frames):
        x = reach * (k / half if k <= half else (n_frames - k) / (n_frames - half))
        poses.append(pose_matrix_np(np.array([x, 0.05 * motion_scale * np.sin(0.1 * k), 0.0, 0.12 * x, 0.0, 0.0])))
    return poses


def rotation_trajectory(n_frames: int, motion_scale: float = 1.0, seed: int = 0) -> list[np.ndarray]:
    """A rotation-dominant path (list of T_cam_from_world): peaks of about 2
    degrees a frame of yaw, pitch and roll with millimetres of translation,
    a fixed 60-frame period, phases drawn from `seed`."""
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0, 2 * np.pi, 6)
    amp_t = np.array([0.015, 0.010, 0.012]) * motion_scale
    amp_r = np.array([0.30, 0.24, 0.36]) * motion_scale
    poses = []
    for k in range(n_frames):
        u = 2 * np.pi * k / 60.0
        poses.append(pose_matrix_np(np.concatenate([
            amp_t * np.sin(u + phase[:3]) - amp_t * np.sin(phase[:3]),
            amp_r * np.sin(u + phase[3:]) - amp_r * np.sin(phase[3:]),
        ])))
    return poses


def make_room_sequence(
    intr: Intrinsics,
    shape: tuple[int, int] = (480, 640),
    n_frames: int = 30,
    motion_scale: float = 1.0,
    seed: int = 0,
    trajectory: str = "forward",
):
    """The room (render_room) along a trajectory: 'forward', 'loop',
    'smooth' or 'rotation'. Returns (intensities, depths, gt world_from_cam
    poses, timestamps at 30 Hz), as make_sequence."""
    traj_fn = {"forward": forward_trajectory, "loop": loop_trajectory, "smooth": smooth_trajectory,
               "rotation": rotation_trajectory}[trajectory]
    intensities, depths, gts = [], [], []
    for T in traj_fn(n_frames, motion_scale, seed):
        I, D = render_room(intr, shape, T)
        intensities.append(I)
        depths.append(D)
        gts.append(np.linalg.inv(T))
    return intensities, depths, gts, np.arange(n_frames, dtype=np.float64) / 30.0


def default_clutter(seed: int = 1) -> list[dict]:
    """Seeded arrangement of floating rectangles in front of the plane."""
    rng = np.random.default_rng(seed)
    objects = []
    for k in range(6):
        n = np.array([rng.uniform(-0.25, 0.25), rng.uniform(-0.25, 0.25), 1.0])
        objects.append(
            dict(
                normal=n,
                d=rng.uniform(1.0, 2.2),
                center=np.array([rng.uniform(-0.9, 0.9), rng.uniform(-0.7, 0.7)]),
                half_extent=np.array([rng.uniform(0.15, 0.45), rng.uniform(0.12, 0.4)]),
                phase=rng.uniform(0, 3.0),
            )
        )
    return objects


def degrade_frame(
    intensity: np.ndarray,
    depth: np.ndarray,
    rng: np.random.Generator,
    exposure_gain: float = 1.0,
    exposure_bias: float = 0.0,
    depth_noise: float = 0.0025,
    hole_fraction: float = 0.02,
    quantize: float = 1.0 / 5000.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Sensor-realistic degradation: exposure drift (gain+bias on intensity),
    Kinect-like depth noise growing ~z^2, 1/5000 m quantization (the TUM
    16-bit PNG step, PhotoconsistencyVisualOdometry.cpp:163), random holes,
    and dropouts at depth discontinuities (where structured-light sensors
    actually fail)."""
    I = np.clip(intensity * exposure_gain + exposure_bias, 0.0, 1.0)
    D = depth.astype(np.float64)
    valid = D > 0
    noise = rng.standard_normal(D.shape) * depth_noise * np.square(D / 2.0)
    D = np.where(valid, D + noise, 0.0)
    if quantize > 0:
        D = np.round(D / quantize) * quantize
    # random holes
    D = np.where(rng.uniform(size=D.shape) < hole_fraction, 0.0, D)
    # edge dropouts: kill pixels near strong depth gradients
    gy, gx = np.gradient(np.where(valid, depth, 0.0))
    edges = np.hypot(gx, gy) > 0.04
    D = np.where(edges & (rng.uniform(size=D.shape) < 0.6), 0.0, D)
    return I.astype(np.float32), D.astype(np.float32)


def make_cluttered_sequence(
    intr: Intrinsics,
    shape: tuple[int, int] = (480, 640),
    n_frames: int = 30,
    motion_scale: float = 1.0,
    seed: int = 0,
    degrade: bool = True,
) -> tuple[list[np.ndarray], list[np.ndarray], list[np.ndarray], np.ndarray]:
    """Hard synthetic sequence: occluding multi-object geometry, depth
    noise/holes/quantization, exposure drift, seeded and exactly
    reproducible. Same return convention as make_sequence."""
    poses_cw = smooth_trajectory(n_frames, motion_scale, seed)
    objects = default_clutter(seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    gains = 1.0 + 0.06 * np.sin(np.linspace(0, 2.5 * np.pi, n_frames) + 0.7)
    biases = 0.02 * np.sin(np.linspace(0, 1.7 * np.pi, n_frames))
    intensities, depths, gts = [], [], []
    for k, T in enumerate(poses_cw):
        I, D = render_cluttered(intr, shape, T, objects)
        if degrade:
            I, D = degrade_frame(I, D, rng, float(gains[k]), float(biases[k]))
        intensities.append(I)
        depths.append(D)
        gts.append(np.linalg.inv(T))
    timestamps = np.arange(n_frames, dtype=np.float64) / 30.0
    return intensities, depths, gts, timestamps


def smooth_trajectory(
    n_frames: int, motion_scale: float = 1.0, seed: int = 0
) -> list[np.ndarray]:
    """Smooth handheld-like camera path (list of T_cam_from_world, first =
    identity): sinusoidal sway with a fixed 60-frame period, ~1.3 cm and
    ~0.3 deg per frame at motion_scale 1, phases drawn from `seed`."""
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0, 2 * np.pi, 6)
    amp_t = np.array([0.12, 0.08, 0.10]) * motion_scale
    amp_r = np.array([0.05, 0.04, 0.06]) * motion_scale
    poses = []
    for k in range(n_frames):
        u = 2 * np.pi * k / 60.0
        state = np.concatenate([
            amp_t * np.sin(u + phase[:3]) - amp_t * np.sin(phase[:3]),
            amp_r * np.sin(u + phase[3:]) - amp_r * np.sin(phase[3:]),
        ])
        poses.append(pose_matrix_np(state))
    return poses


def make_sequence(
    intr: Intrinsics,
    shape: tuple[int, int] = (480, 640),
    n_frames: int = 30,
    motion_scale: float = 1.0,
    seed: int = 0,
    trajectory: str = "smooth",
):
    """Synthetic RGB-D sequence of the plane along smooth_trajectory
    ('smooth', translation-dominant) or rotation_trajectory ('rotation').
    Returns (intensities, depths, gt world_from_cam poses, timestamps at 30
    Hz); the gt poses are what integrating pose <- pose @ Rt^-1
    reproduces."""
    traj_fn = {"smooth": smooth_trajectory, "rotation": rotation_trajectory}[trajectory]
    intensities, depths, gts = [], [], []
    for T in traj_fn(n_frames, motion_scale, seed):
        I, D = render_plane(intr, shape, T)
        intensities.append(I)
        depths.append(D)
        gts.append(np.linalg.inv(T))
    return intensities, depths, gts, np.arange(n_frames, dtype=np.float64) / 30.0


def make_pair(
    intr: Intrinsics,
    shape: tuple[int, int] = (480, 640),
    state: np.ndarray | None = None,
):
    """(I0, D0, I1, D1, gt_state): pose_matrix(gt_state) takes source
    (frame 0) camera points into the target (frame 1) camera frame."""
    if state is None:
        state = np.array([0.02, -0.015, 0.01, 0.008, -0.006, 0.01], dtype=np.float32)
    state = np.asarray(state, dtype=np.float32)
    I0, D0 = render_plane(intr, shape, np.eye(4))
    I1, D1 = render_plane(intr, shape, pose_matrix_np(state))
    return I0, D0, I1, D1, state
