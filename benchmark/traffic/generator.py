"""The benchmark's RGB-D sequence, rendered on the device from the seed.

A torch copy of the port's cluttered-scene generator
(phovo_tpu_torch/utils/synthetic.py: render_cluttered, default_clutter,
degrade_frame), batched over frames so a whole TUM-length sequence renders
in a second on the card, and a camera path at the speeds a sequence
names. The frames come back as TUM stores them: uint8 gray intensity and
uint16 depth counts (5000 a metre, 0 where the sensor has no return).

The path is periodic over the sequence: every camera component is a sum
of sines with a whole number of cycles over the frames, so the last frame
steps to the first as any frame steps to the next, and a stream may start
anywhere and wrap around. Its amplitudes are scaled so the mean speed of
the camera centre and the mean rotation between frames are the ones the
traffic names; the seed draws the phases, the clutter and the sensor
noise, never the sizes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# cycles over the sequence of each camera-centre axis and each of yaw,
# pitch and roll: slow sweeps of translation, faster wobbles of rotation
TRANSLATION_CYCLES = (5, 6, 7)
ROTATION_CYCLES = (13, 15, 17)


def _rotation_zyx(yaw, pitch, roll):
    """(...,) angles -> (..., 3, 3) rotation Rz(yaw) Ry(pitch) Rx(roll)."""
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    rows = [
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _mean_speeds(centres, rotations):
    """Mean distance and mean rotation angle (rad) between consecutive
    frames of a periodic path, the last frame stepping to the first."""
    step = torch.roll(centres, -1, dims=0) - centres
    rel = rotations.transpose(-1, -2) @ torch.roll(rotations, -1, dims=0)
    cos = ((rel.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0).clamp(-1.0, 1.0)
    return float(step.norm(dim=-1).mean()), float(torch.acos(cos).mean())


def camera_path(n_frames: int, fps: float, speed_m_s: float, turn_deg_s: float,
                gen: torch.Generator, device) -> torch.Tensor:
    """(n_frames, 4, 4) float64 camera-from-world transforms of a periodic
    path whose camera centre moves speed_m_s and turns turn_deg_s on
    average, at fps frames a second. Frame 0 is at the world origin
    looking down +z at the scene; the phases come from gen."""
    phase = torch.rand(6, generator=gen, device=gen.device, dtype=torch.float64).to(device) * (2 * math.pi)
    u = torch.arange(n_frames, dtype=torch.float64, device=device) * (2 * math.pi / n_frames)
    cycles = torch.tensor(TRANSLATION_CYCLES + ROTATION_CYCLES, dtype=torch.float64, device=device)
    # unit sways, zero at frame 0
    sway = torch.sin(u[:, None] * cycles + phase) - torch.sin(phase)
    centre_unit, angle_unit = sway[:, :3], sway[:, 3:]

    def path(a_t, a_r):
        return centre_unit * a_t, _rotation_zyx(*(angle_unit * a_r).unbind(-1))

    # the mean rotation is close to linear in the amplitude at these
    # sizes: three rescalings land within 0.1% of the asked speeds
    a_t, a_r = 1.0, 0.1
    for _ in range(3):
        d_t, d_r = _mean_speeds(*path(a_t, a_r))
        a_t *= speed_m_s / fps / d_t
        a_r *= math.radians(turn_deg_s) / fps / d_r
    centres, rot_wc = path(a_t, a_r)
    T = torch.zeros((n_frames, 4, 4), dtype=torch.float64, device=device)
    T[:, :3, :3] = rot_wc.transpose(-1, -2)
    T[:, :3, 3] = -(rot_wc.transpose(-1, -2) @ centres[:, :, None])[..., 0]
    T[:, 3, 3] = 1.0
    return T


def _texture(x, y):
    """The port's smooth, non-periodic intensity in [0, 1] over plane
    coordinates (utils/synthetic.py::_texture)."""
    v = (
        0.5
        + 0.18 * torch.sin(3.1 * x) * torch.cos(2.3 * y)
        + 0.12 * torch.sin(7.3 * x + 1.1)
        + 0.10 * torch.cos(5.7 * y + 0.4)
        + 0.10 * torch.sin(2.1 * (x + y))
    )
    return v.clamp(0.0, 1.0)


def clutter(gen: torch.Generator, n_objects: int = 6) -> list[dict]:
    """Floating textured rectangles before the background plane, drawn as
    the port's default_clutter draws them (normal tilt, offset, centre,
    half extents, texture phase)."""

    def uni(lo, hi, n=1):
        return (lo + (hi - lo) * torch.rand(n, generator=gen, device=gen.device, dtype=torch.float64)).cpu()

    objects = []
    for _ in range(n_objects):
        objects.append(dict(
            normal=(float(uni(-0.25, 0.25)), float(uni(-0.25, 0.25)), 1.0),
            d=float(uni(1.0, 2.2)),
            center=(float(uni(-0.9, 0.9)), float(uni(-0.7, 0.7))),
            half_extent=(float(uni(0.15, 0.45)), float(uni(0.12, 0.4))),
            phase=float(uni(0.0, 3.0)),
        ))
    return objects


def render_cluttered(intr, shape, T_cw: torch.Tensor, objects, plane_normal=(0.06, -0.04, 1.0),
                     plane_d: float = 2.6):
    """(F, H, W) float64 (intensity, depth) of the background plane and the
    objects seen from F camera-from-world transforms (F, 4, 4), nearest hit
    along each pixel ray; a ray that hits nothing has depth 0."""
    H, W = shape
    fx, fy, cx, cy = (float(v) for v in intr)
    dev = T_cw.device
    R, t = T_cw[:, :3, :3], T_cw[:, :3, 3]
    vx = ((torch.arange(W, dtype=torch.float64, device=dev) - cx) / fx)[None, None, :]
    vy = ((torch.arange(H, dtype=torch.float64, device=dev) - cy) / fy)[None, :, None]

    def hit(normal):
        n_c = R @ torch.tensor(normal, dtype=torch.float64, device=dev)  # (F, 3)
        return n_c, (n_c * t).sum(-1)

    def world(z):
        # R^T (p_c - t) with p_c = (vx z, vy z, z)
        pc = torch.stack(torch.broadcast_tensors(vx * z, vy * z, z), dim=-1) - t[:, None, None, :]
        return torch.einsum("fhwi,fij->fhwj", pc, R)

    def depth_to(normal, d):
        n_c, nt = hit(normal)
        denom = n_c[:, 0, None, None] * vx + n_c[:, 1, None, None] * vy + n_c[:, 2, None, None]
        z = (d + nt)[:, None, None] / denom
        return torch.where((denom > 1e-9) & (z > 0.05), z, torch.full_like(z, math.inf))

    z_best = depth_to(plane_normal, plane_d)
    pw = world(torch.where(torch.isfinite(z_best), z_best, 0.0))
    intensity = _texture(pw[..., 0], pw[..., 1])
    for k, obj in enumerate(objects):
        z = depth_to(obj["normal"], obj["d"])
        pw = world(torch.where(torch.isfinite(z), z, 0.0))
        inside = ((pw[..., 0] - obj["center"][0]).abs() < obj["half_extent"][0]) & (
            (pw[..., 1] - obj["center"][1]).abs() < obj["half_extent"][1])
        closer = inside & (z < z_best)
        tex = _texture((pw[..., 0] + obj["phase"]) * (1.3 + 0.2 * k), (pw[..., 1] - obj["phase"]) * (1.1 + 0.15 * k))
        intensity = torch.where(closer, tex, intensity)
        z_best = torch.where(closer, z, z_best)
    return intensity, torch.where(torch.isfinite(z_best), z_best, 0.0)


def _gradient(img):
    """numpy.gradient of (F, H, W) along rows and columns: central
    differences inside, one-sided at the borders."""

    def along(x, dim):
        n = x.shape[dim]
        g = torch.empty_like(x)
        mid = (x.narrow(dim, 2, n - 2) - x.narrow(dim, 0, n - 2)) / 2.0
        g.narrow(dim, 1, n - 2).copy_(mid)
        g.narrow(dim, 0, 1).copy_(x.narrow(dim, 1, 1) - x.narrow(dim, 0, 1))
        g.narrow(dim, n - 1, 1).copy_(x.narrow(dim, n - 1, 1) - x.narrow(dim, n - 2, 1))
        return g

    return along(img, -2), along(img, -1)


def degrade(intensity, depth, gen, gains, biases, sensor: dict):
    """The port's degrade_frame on F frames at once: exposure gain and bias,
    depth noise growing as z^2, random holes, dropouts at depth edges; then
    TUM storage: uint8 intensity and depth counts (depth_counts_per_m a
    metre, 0 beyond max_range_m). Returns (uint8 (F, H, W), int32 counts)."""
    I = (intensity * gains[:, None, None] + biases[:, None, None]).clamp(0.0, 1.0)
    valid = depth > 0

    def uniform():
        return torch.rand(depth.shape, generator=gen, device=gen.device, dtype=torch.float64).to(depth.device)

    noise = torch.randn(depth.shape, generator=gen, device=gen.device, dtype=torch.float64).to(depth.device)
    D = torch.where(valid, depth + noise * sensor["depth_noise_m"] * (depth / 2.0) ** 2, 0.0)
    D = torch.where(uniform() < sensor["hole_fraction"], 0.0, D)
    gy, gx = _gradient(torch.where(valid, depth, 0.0))
    edges = torch.hypot(gx, gy) > sensor["edge_step_m"]
    D = torch.where(edges & (uniform() < sensor["edge_dropout"]), 0.0, D)
    counts = torch.round(D * sensor["depth_counts_per_m"]).to(torch.int32)
    counts = torch.where((D > sensor["max_range_m"]) | (counts < 0), 0, counts)
    return torch.round(I * 255.0).to(torch.uint8), counts


def make_sequence(scene: dict, camera: dict, seed: int, device, batch: int = 32):
    """The sequence a cell replays: (uint8 intensity (N, H, W), uint16 depth
    counts (N, H, W)) numpy arrays in host memory, rendered on `device` from
    `seed` in batches of `batch` frames. scene holds the path (frames, fps,
    speed_m_s, turn_deg_s), the clutter and the sensor; camera the frame
    size and intrinsics."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n = int(scene["frames"])
    shape = (int(camera["height"]), int(camera["width"]))
    intr = (camera["fx"], camera["fy"], camera["cx"], camera["cy"])
    T = camera_path(n, scene["fps"], scene["speed_m_s"], scene["turn_deg_s"], gen, device)
    objects = clutter(gen, int(scene["objects"]))
    u = torch.arange(n, dtype=torch.float64, device=device) * (2 * math.pi / n)
    exposure = scene["exposure"]
    gains = 1.0 + exposure["gain"] * torch.sin(exposure["gain_cycles"] * u + 0.7)
    biases = exposure["bias"] * torch.sin(exposure["bias_cycles"] * u)
    I8 = np.empty((n, *shape), np.uint8)
    D16 = np.empty((n, *shape), np.uint16)
    for lo in range(0, n, batch):
        hi = min(n, lo + batch)
        inten, depth = render_cluttered(intr, shape, T[lo:hi], objects)
        i8, counts = degrade(inten, depth, gen, gains[lo:hi], biases[lo:hi], scene["sensor"])
        I8[lo:hi] = i8.cpu().numpy()
        D16[lo:hi] = counts.to(torch.int16).cpu().numpy().view(np.uint16)
    return I8, D16
