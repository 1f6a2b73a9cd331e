"""The prep layer: frames in storage dtype to the packs the level kernels
read, at every active pyramid level.

A frame's packs at a level (ops/fused.py's layouts): the source pack, i0
(H*W) and geom (4 | 6, H*W) (pack_geometry: the back-projected points, the
depth-range mask and, with gradient_at='esm', the frame's own gradients),
and the target pack t_all (3, H, W) (pack_target: the intensity and its
Scharr gradients). Intensity comes as uint8 (times 1/255 on the device) or
float32 0..1, depth as uint16 counts (times depth_scale) or float32 metres.

Two routes compute them, with the same bits on the card:
  * K-PREP (csrc/prep_levels.cu, prep_levels): one launch for every frame
    and every active level, straight from the frames in storage dtype. A
    call takes it where it observes that it can: its tensors on a CUDA
    card in those dtypes, no blur at an active level, and every active
    level an exact power-of-two downscale of the frame, at least 2x2
    (kernel_takes). PREP_LAUNCHES counts its launches, those of replayed
    CUDA graphs included (models/base.CallGraph: the object API's pairs,
    the serving rounds);
  * the torch chain (prep_levels_torch): the conversion, ops/pyramid.py's
    pyramids and Scharr gradients and ops/fused.py's pack_geometry and
    pack_target, op by op. It is the plain version: CPU tensors take it,
    and so does every CUDA call K-PREP does not take. PREP_TORCH_CALLS
    counts the calls that ran it.

The entries: prep_frames (every frame as source and target: the
level-major sequences, serving, keyframes), prep_targets (targets only:
tracked frames), prep_chunk (the chunked entries' carry frame and new
frames: the pairs' packs and the new carry) and prep_pair (one pair of the
object API's trust-region route).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from phovo_tpu_torch.ops import pyramid as pyr
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.fused import pack_geometry, pack_target
from phovo_tpu_torch.utils import profiling

# Launches of K-PREP in this process, and calls that ran the torch chain
# instead. Each entry adds one to either, and a replay of a captured call
# (models/base.CallGraph: the object API's pair, the serving round) adds
# the K-PREP launches it holds, so a caller can show which route its run
# took (reset both to 0 before the run, read them after).
PREP_LAUNCHES = 0
PREP_TORCH_CALLS = 0

_INTENSITY_DTYPES = (torch.uint8, torch.float32)
_DEPTH_DTYPES = (torch.uint16, torch.float32)


def device_unit_intensity(img: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 * (1/255) on the tensor's device (the reference
    SetSourceFrame conversion; a multiply, as phovo_tpu does, not a
    divide); float inputs pass through."""
    if img.dtype == torch.uint8:
        return img.to(torch.float32) * (1.0 / 255.0)
    return img


def chunk_device_prep(carry_intensity, carry_depth, intensities, depths, depth_scale):
    """Storage-dtype conversion and carry-frame prepend of the chunked
    sequence entry, on the device the tensors live on: per chunk the host
    moves only the new frames, in storage dtype (uint8 intensity, uint16
    depth counts times depth_scale); the carry frame stays on the device.
    Returns (I (B+1, H, W) float32, D (B+1, H, W) float32 metres)."""
    with profiling.span("phovo.prep"):
        if depth_scale is not None and depths.dtype != torch.float32:
            depths = depths.to(torch.float32) * float(np.float32(depth_scale))
        intensities = device_unit_intensity(intensities).to(torch.float32)
        carry_f = device_unit_intensity(carry_intensity).to(torch.float32)
        I = torch.cat([carry_f[None], intensities])
        D = torch.cat([carry_depth.to(torch.float32)[None], depths])
    return I, D


def _active_levels(config) -> list[int]:
    return [level for level in range(config.num_levels) if config.max_iterations[level] > 0]


def _downscale(shape: tuple[int, int], level: int) -> tuple[int, int] | None:
    """(kr, kc) when pyramid level `level` of an H x W frame is exactly the
    frame downscaled by 2^kr rows and 2^kc columns (0, 0 at full
    resolution) and at least 2x2, the reflect-101 border's least size;
    None otherwise."""
    Hl, Wl = pyr.level_shape(shape, level)
    if Hl < 2 or Wl < 2:
        return None
    if (Hl, Wl) == tuple(shape):
        return 0, 0
    kr, kc = pyr._pow2_factor(shape[0], Hl), pyr._pow2_factor(shape[1], Wl)
    return None if kr is None or kc is None else (kr, kc)


def kernel_takes(config, shape: tuple[int, int]) -> bool:
    """Whether K-PREP computes config's packs of H x W frames: no blur at
    an active level, and every active level an exact power-of-two
    downscale of the frame, at least 2x2. (Of the 12 shipped presets at
    640x480, the three that blur an active level are the ones it does not
    take.)"""
    return all(
        int(config.blur_filter_sizes[level]) <= 0 and _downscale(tuple(shape), level) is not None
        for level in _active_levels(config)
    )


def frames_take_kernel(config, shape, device, intensity_dtypes, depth_dtypes, depth_scale=None) -> bool:
    """Whether K-PREP takes frames of this H x W shape on `device` with
    these dtypes: a CUDA card, H and W above 0, intensities uint8 or
    float32, depths uint16 (with a depth_scale) or float32, and
    kernel_takes(config, shape)."""
    return (torch.device(device).type == "cuda" and min(shape) > 0
            and all(d in _INTENSITY_DTYPES for d in intensity_dtypes)
            and all(d in _DEPTH_DTYPES and (d != torch.uint16 or depth_scale is not None) for d in depth_dtypes)
            and kernel_takes(config, shape))


def _on_kernel(config, shape, intensities, depths, depth_scale=None) -> bool:
    """Whether a call with these frames takes K-PREP: every tensor on a
    CUDA card, not empty and H x W, and frames_take_kernel for their
    dtypes."""
    if not all(t.device.type == "cuda" and t.numel() > 0 and tuple(t.shape[-2:]) == shape
               for t in (*intensities, *depths)):
        return False
    return frames_take_kernel(config, shape, intensities[0].device, [t.dtype for t in intensities],
                              [t.dtype for t in depths], depth_scale)


def _check_frames(head, body_i, body_d, depth_scale, sources, targets) -> tuple[int, int, int]:
    """Raise on what K-PREP does not take; returns (F, H, W)."""
    tensors = {"body intensity": body_i}
    if body_d is not None:
        tensors["body depth"] = body_d
    if head is not None:
        tensors["head intensity"], tensors["head depth"] = head
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != body_i.device:
            raise ValueError(f"{name} is on {t.device}, the body intensity on {body_i.device}")
    for name, t in tensors.items():
        allowed = (torch.float32,) if name == "head depth" else (
            _DEPTH_DTYPES if "depth" in name else _INTENSITY_DTYPES)
        if t.dtype not in allowed:
            raise ValueError(f"{name} must be one of {allowed}, got {t.dtype}")
    if body_i.dim() != 3:
        raise ValueError(f"body intensity must be (n, H, W), got {tuple(body_i.shape)}")
    n, H, W = body_i.shape
    if body_d is not None and tuple(body_d.shape) != (n, H, W):
        raise ValueError(f"body depth has shape {tuple(body_d.shape)}, expected {(n, H, W)}")
    if body_d is not None and body_d.dtype == torch.uint16 and depth_scale is None:
        raise ValueError("uint16 depth counts need a depth_scale")
    if head is not None and any(tuple(t.shape) != (H, W) for t in head):
        raise ValueError(f"the head frame must be ({H}, {W}), got {[tuple(t.shape) for t in head]}")
    F = n + (head is not None)
    (s0, s1), (t0, t1) = sources, targets
    if not (0 <= s0 <= s1 <= F and 0 <= t0 <= t1 <= F) or (s0 < s1 and t0 < t1 and (s1 < t0 or t1 < s0)):
        raise ValueError(f"sources {sources} and targets {targets} must be ranges of the {F} frames that meet")
    if s0 < s1 and body_d is None and s1 > (head is not None):
        raise ValueError("source frames need their depth")
    return F, H, W


def prep_levels(head, body_i, body_d, intr: Intrinsics | None, config, *, sources, targets,
                depth_scale=None, carry=False):
    """K-PREP: every active level's packs of frames 0 .. F-1 in one launch.
    head is frame 0 as (intensity (H, W) uint8 or float32, depth (H, W)
    float32 metres), or None; body_i (n, H, W) uint8 or float32 and body_d
    (n, H, W) uint16 counts (times depth_scale) or float32 metres, or None
    for target frames only, are the others. Frames sources[0] ..
    sources[1] - 1 get source packs, targets[0] .. targets[1] - 1 target
    packs, numbered from 0 within each range; the ranges must meet. Returns
    ({level: (i0 (S, H*W), geom (S, 4 | 6, H*W), t_all (T, 3, H, W))}, None
    for a role no frame has, and with carry the last frame's float32 (I,
    D) at full resolution, else None). Raises on what the kernel does not
    take, on a device other than a CUDA card, and on a failed build or
    launch; kernel_takes(config, (H, W)) must hold."""
    global PREP_LAUNCHES
    F, H, W = _check_frames(head, body_i, body_d, depth_scale, sources, targets)
    dev = body_i.device
    if dev.type != "cuda":
        raise ValueError(f"no K-PREP for device {dev}")
    if not kernel_takes(config, (H, W)):
        raise ValueError(f"K-PREP does not take this config at {H}x{W} (a blurred or inexact active level)")

    from phovo_tpu_torch.ops import _build

    lib = _build.library()
    S, T = sources[1] - sources[0], targets[1] - targets[0]
    geom_rows = 6 if config.gradient_at == "esm" else 4
    levels = _active_levels(config)
    ints, floats, outs, packs = [], [], [], {}
    for level in levels:
        Hl, Wl = pyr.level_shape((H, W), level)
        # targets only: the geometry's constants go unread
        intr_l = intr.at_level(level) if intr is not None else Intrinsics(1.0, 1.0, 0.0, 0.0)
        i0 = torch.empty((S, Hl * Wl), dtype=torch.float32, device=dev) if S else None
        geom = torch.empty((S, geom_rows, Hl * Wl), dtype=torch.float32, device=dev) if S else None
        t_all = torch.empty((T, 3, Hl, Wl), dtype=torch.float32, device=dev) if T else None
        packs[level] = (i0, geom, t_all)
        ints += [*_downscale((H, W), level), Hl, Wl]
        # torch divides by a CPU scalar as a multiply by its float32 reciprocal
        floats += [config.gradient_scales[level], intr_l.cx, intr_l.cy,
                   float(np.float32(1.0) / np.float32(intr_l.fx)), float(np.float32(1.0) / np.float32(intr_l.fy))]
        outs += [None if t is None else t.data_ptr() for t in (i0, geom, t_all)]
    n = len(levels)
    c_ints, c_floats = (ctypes.c_int * max(4 * n, 1))(*ints), (ctypes.c_float * max(5 * n, 1))(*floats)
    c_outs = (ctypes.c_void_p * max(3 * n, 1))(*outs)
    carry_out = tuple(torch.empty((H, W), dtype=torch.float32, device=dev) for _ in range(2)) if carry else None
    head_i, head_d = head if head is not None else (None, None)
    with torch.cuda.device(dev):
        err = lib.phovo_prep_levels(
            None if head_i is None else head_i.data_ptr(), None if head_d is None else head_d.data_ptr(),
            body_i.data_ptr(), None if body_d is None else body_d.data_ptr(),
            int(head_i is not None and head_i.dtype == torch.uint8), int(body_i.dtype == torch.uint8),
            int(body_d is not None and body_d.dtype == torch.uint16),
            float(np.float32(depth_scale)) if depth_scale is not None else 1.0,
            F, H, W, *sources, *targets, int(geom_rows == 6), float(config.min_depth), float(config.max_depth),
            n, ctypes.addressof(c_ints), ctypes.addressof(c_floats), ctypes.addressof(c_outs),
            None if carry_out is None else carry_out[0].data_ptr(),
            None if carry_out is None else carry_out[1].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err:
            raise RuntimeError(f"prep_levels kernel launch failed: CUDA error {err} ({F} frames, {H}x{W}, "
                               f"levels {levels})")
        PREP_LAUNCHES += 1
    return packs, carry_out


def prep_levels_torch(intensity, depth, intr: Intrinsics, config, targets: bool = True) -> dict:
    """The torch chain, the plain version of K-PREP, op by op: level ->
    (i0 (..., H*W), geom (..., 4 | 6, H*W), t_all (..., 3, H, W)) for every
    active level of frames (..., H, W) in float32; depth None gives no
    source packs (i0 and geom None), targets False no t_all (None). Each
    level is resized from the original and blurred (ops/pyramid.py), its
    Scharr gradients taken where a target pack or the ESM rows need
    them."""
    L = config.num_levels
    esm = config.gradient_at == "esm"
    out = {}
    int_p = pyr.build_pyramid(intensity, L, config.blur_filter_sizes, blur_type=config.blur_type)
    dep_p = pyr.build_pyramid(depth, L) if depth is not None else None
    for level in _active_levels(config):
        img = int_p[level]
        scale = config.gradient_scales[level]
        gx = gy = None
        if targets or (depth is not None and esm):
            gx, gy = pyr.scharr(img, "x", scale), pyr.scharr(img, "y", scale)
        i0 = geom = None
        if depth is not None:
            i0 = img.reshape(*img.shape[:-2], -1)
            geom = pack_geometry(dep_p[level], intr.at_level(level), config.min_depth, config.max_depth,
                                 (gx, gy) if esm else None)
        out[level] = (i0, geom, pack_target(img, gx, gy) if targets else None)
    return out


def _torch_call() -> None:
    global PREP_TORCH_CALLS
    PREP_TORCH_CALLS += 1


def prep_frames(intensity: torch.Tensor, depth: torch.Tensor, intr: Intrinsics, config) -> dict:
    """Per-frame packs for every ACTIVE pyramid level of frames (..., H, W)
    (intensity float32 0..1 or uint8, depth float32 metres): level -> (i0
    (..., H*W), geom (..., 4 | 6, H*W), t_all (..., 3, H, W)); leading dims
    are frames. With gradient_at='esm' the geometry carries the frame's
    own level gradients as rows 4 and 5, the same arrays as its target
    pack's gx and gy."""
    with profiling.span("phovo.prep"):
        lead, shape = intensity.shape[:-2], tuple(intensity.shape[-2:])
        if depth.shape != intensity.shape or not _on_kernel(config, shape, [intensity], [depth]):
            _torch_call()
            return prep_levels_torch(device_unit_intensity(intensity).to(torch.float32), depth.to(torch.float32),
                                     intr, config)
        F = math.prod(lead)
        packs, _ = prep_levels(
            None, intensity.reshape(F, *shape).contiguous(), depth.reshape(F, *shape).contiguous(), intr, config,
            sources=(0, F), targets=(0, F),
        )
        return {level: (i0.reshape(*lead, -1), geom.reshape(*lead, *geom.shape[1:]),
                        t_all.reshape(*lead, *t_all.shape[1:]))
                for level, (i0, geom, t_all) in packs.items()}


def prep_targets(intensity: torch.Tensor, config) -> dict:
    """Target packs only, for every ACTIVE level: level -> t_all (..., 3, H,
    W), the same arrays as prep_frames' third member. Frames tracked
    against a keyframe are targets only (the reference's SetTargetFrame
    ignores depth), so they need neither depth nor a geometry pack."""
    with profiling.span("phovo.prep"):
        lead, shape = intensity.shape[:-2], tuple(intensity.shape[-2:])
        if not _on_kernel(config, shape, [intensity], []):
            _torch_call()
            packs = prep_levels_torch(device_unit_intensity(intensity).to(torch.float32), None, None, config)
            return {level: t_all for level, (_, _, t_all) in packs.items()}
        F = math.prod(lead)
        packs, _ = prep_levels(None, intensity.reshape(F, *shape).contiguous(), None, None, config,
                               sources=(0, 0), targets=(0, F))
        return {level: t_all.reshape(*lead, *t_all.shape[1:]) for level, (_, _, t_all) in packs.items()}


def prep_chunk(carry_intensity, carry_depth, intensities, depths, depth_scale, intr: Intrinsics, config):
    """The packs of a chunk's B pairs, frame k - 1 to frame k of the carry
    frame (H, W) (uint8 or float32; depth float32 metres) and the B new
    frames (B, H, W) (uint8 or float32; uint16 counts times depth_scale, or
    float32 metres): ({level: (i0 (B, H*W), geom (B, 4 | 6, H*W), t_all
    (B, 3, H, W))}, the new carry intensity (H, W), its depth), the carry
    in float32. K-PREP builds them from the storage-dtype frames in one
    launch, the carry with them; the torch chain converts and prepends the
    carry (chunk_device_prep), then preps every frame."""
    with profiling.span("phovo.prep"):
        shape = tuple(intensities.shape[-2:])
        on_kernel = carry_depth.dtype == torch.float32 and _on_kernel(
            config, shape, [carry_intensity, intensities], [carry_depth, depths], depth_scale)
        if not on_kernel:
            _torch_call()
            I, D = chunk_device_prep(carry_intensity, carry_depth, intensities, depths, depth_scale)
            packs = prep_levels_torch(I, D, intr, config)
            pairs = {level: (i0[:-1], geom[:-1], t_all[1:]) for level, (i0, geom, t_all) in packs.items()}
            return pairs, I[-1], D[-1]
        B = intensities.shape[0]
        packs, (ci, cd) = prep_levels(
            (carry_intensity.contiguous(), carry_depth.contiguous()), intensities.contiguous(), depths.contiguous(),
            intr, config, sources=(0, B), targets=(1, B + 1), depth_scale=depth_scale, carry=True,
        )
        return packs, ci, cd


def prep_pair(source_intensity, source_depth, target_intensity, intr: Intrinsics, config) -> dict:
    """The packs of one pair (each frame (H, W), intensity uint8 or float32,
    the source's depth float32 metres): level -> (i0 (1, H*W), geom (1, 4 |
    6, H*W), t_all (1, 3, H, W)), the source's and the target's. K-PREP
    builds them in one launch."""
    with profiling.span("phovo.prep"):
        shape = tuple(source_intensity.shape[-2:])
        on_kernel = source_depth.dtype == torch.float32 and source_intensity.dim() == 2 and _on_kernel(
            config, shape, [source_intensity, target_intensity], [source_depth])
        if not on_kernel:
            _torch_call()
            si = device_unit_intensity(source_intensity).to(torch.float32)
            ti = device_unit_intensity(target_intensity).to(torch.float32)
            src = prep_levels_torch(si, source_depth.to(device=si.device, dtype=torch.float32), intr, config,
                                    targets=False)
            tgt = prep_levels_torch(ti, None, intr, config)
            return {level: (i0[None], geom[None], tgt[level][2][None]) for level, (i0, geom, _) in src.items()}
        packs, _ = prep_levels(
            (source_intensity.contiguous(), source_depth.contiguous()), target_intensity.reshape(1, *shape).contiguous(),
            None, intr, config, sources=(0, 1), targets=(1, 2),
        )
        return packs
