"""phovo_tpu_torch ops held to the phovo_tpu ops on the CPU.

Inputs are made with numpy from a seed and handed to both packages. Unless
a test says otherwise the tolerance is 1e-5 absolute on O(1) quantities
(or relative to the largest reference entry for sums over pixels): both
sides compute in float32, and only the order of additions differs
(float32 reassociation, a few ulp over the sizes used here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phovo_tpu.ops import camera as jcam
from phovo_tpu.ops import pyramid as jpyr
from phovo_tpu.ops import residuals as jres
from phovo_tpu.ops import se3 as jse3
from phovo_tpu.ops import warp as jwarp
from phovo_tpu_torch.ops import camera as tcam
from phovo_tpu_torch.ops import pyramid as tpyr
from phovo_tpu_torch.ops import residuals as tres
from phovo_tpu_torch.ops import se3 as tse3
from phovo_tpu_torch.ops import warp as twarp
from phovo_tpu_torch.utils.synthetic import make_pair

ATOL = 1e-5

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(port, ref, atol=ATOL, scaled=False):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    if scaled:
        atol = atol * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port, ref, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def states():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((5, 6)) * [0.1, 0.1, 0.1, 0.3, 0.3, 0.3]).astype(np.float32)


def _torch_intr(intr):
    return tcam.Intrinsics(*(float(v) for v in intr))


# --- se3 ---------------------------------------------------------------


def test_pose_matrix_inverse_compose(states):
    T = tse3.pose_matrix(_t(states))
    jT = jse3.pose_matrix(jnp.asarray(states))
    _close(T, jT)
    _close(tse3.inverse(T), jse3.inverse(jT))
    _close(tse3.compose(T[:-1], T[1:]), jse3.compose(jT[:-1], jT[1:]))
    _close(tse3.matrix_to_state(T), jse3.matrix_to_state(jT))
    _close(tse3.rotation_jacobian_wrt_euler(_t(states)),
           jax.vmap(jse3.rotation_jacobian_wrt_euler)(jnp.asarray(states)))


@pytest.mark.parametrize("n", [1, 5, 8])
def test_integrate_trajectory(states, n):
    s = np.concatenate([states] * 2)[:n]
    _close(tse3.integrate_trajectory(_t(s)), jse3.integrate_trajectory(jnp.asarray(s)))


def test_host_twins(states):
    s64 = states.astype(np.float64)
    np.testing.assert_allclose(tse3.pose_matrix_np(s64), jse3.pose_matrix_np(s64), atol=1e-12)
    R = jse3.pose_matrix_np(s64)[..., :3, :3]
    np.testing.assert_allclose(
        tse3.rotation_to_quaternion_np(R), jse3.rotation_to_quaternion_np(R), atol=1e-12
    )


# --- camera ------------------------------------------------------------


def test_intrinsics_levels_and_presets():
    K = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]], np.float64)
    t = tcam.Intrinsics.from_matrix(K)
    j = jcam.Intrinsics.from_matrix(jnp.asarray(K, jnp.float32))
    assert t == tuple(float(v) for v in j)
    assert tcam.TUM_FR1 == tuple(float(v) for v in jcam.TUM_FR1)
    assert tcam.TUM_DEFAULT == tuple(float(v) for v in jcam.TUM_DEFAULT)
    for level in range(6):
        # cx / 2^level, not the pixel-centre-preserving convention
        assert t.at_level(level) == tuple(float(v) for v in j.at_level(level))


def test_backproject_project(intr):
    D = np.random.default_rng(3).uniform(0.5, 4.0, (7, 9)).astype(np.float32)
    ti = _torch_intr(intr)
    pts = tcam.backproject(_t(D), ti)
    jpts = jcam.backproject(jnp.asarray(D), intr)
    _close(pts, jpts)
    for a, b in zip(tcam.project(pts, ti), jcam.project(jpts, intr)):
        _close(a, b)


# --- pyramid -----------------------------------------------------------


@pytest.mark.parametrize(
    "shape,out",
    [
        ((96, 128), (48, 64)),  # exact 1/2: strided fast path
        ((96, 128), (24, 32)),  # exact 1/4
        ((45, 60), (23, 30)),  # odd rows: banded-matrix fallback
        ((37, 53), (9, 13)),  # odd and non-pow-2 in both axes
    ],
)
def test_resize_bilinear(shape, out):
    img = np.random.default_rng(0).random((2,) + shape).astype(np.float32)
    _close(tpyr.resize_bilinear(_t(img), out), jpyr.resize_bilinear(jnp.asarray(img), out))


@pytest.mark.parametrize("shape", [(480, 640), (45, 60), (37, 53), (1, 1)])
def test_level_shape(shape):
    for level in range(6):
        assert tpyr.level_shape(shape, level) == jpyr.level_shape(shape, level)


@pytest.mark.parametrize(
    "op",
    [
        ("gaussian", 3), ("gaussian", 5), ("box", 3), ("box", 4),
        ("scharr_x", 0.0625), ("scharr_y", 0.25),
    ],
)
def test_filters(op):
    img = np.random.default_rng(1).random((2, 23, 30)).astype(np.float32)
    kind, arg = op
    t, j = _t(img), jnp.asarray(img)
    if kind == "gaussian":
        pair = tpyr.gaussian_blur(t, arg), jpyr.gaussian_blur(j, arg)
    elif kind == "box":
        pair = tpyr.box_blur(t, arg), jpyr.box_blur(j, arg)
    else:
        axis = kind[-1]
        pair = tpyr.scharr(t, axis, arg), jpyr.scharr(j, axis, arg)
    _close(*pair)


@pytest.mark.parametrize("blur_type", ["gaussian", "box"])
def test_build_pyramids(blur_type):
    img = np.random.default_rng(2).random((45, 60)).astype(np.float32)
    blur, scales = (5, 3, 0), (0.0625, 0.125, 0.25)
    tp = tpyr.build_pyramid(_t(img), 3, blur, blur_type=blur_type)
    jp = jpyr.build_pyramid(jnp.asarray(img), 3, blur, blur_type=blur_type)
    for a, b in zip(tp, jp):
        _close(a, b)
    for tg, jg in zip(tpyr.build_gradient_pyramid(tp, scales), jpyr.build_gradient_pyramid(jp, scales)):
        for a, b in zip(tg, jg):
            _close(a, b)


# --- warp --------------------------------------------------------------


def test_transform_points(states):
    pts = np.random.default_rng(4).standard_normal((6, 7, 3)).astype(np.float32)
    T = jse3.pose_matrix(jnp.asarray(states[1]))
    _close(twarp.transform_points(_t(pts), _t(np.asarray(T))),
           jwarp.transform_points(jnp.asarray(pts), T))


def _coords(H, W):
    """Sample points that include exact .5 ties (round half to even), the
    bilinear in-bounds edges 0 and W (H) and points outside the image."""
    rng = np.random.default_rng(5)
    col = np.concatenate([
        rng.uniform(-2, W + 1, 40), [0.5, 1.5, 2.5, -0.5, W - 0.5, W - 1.5, 0.0, W - 1.0, W, -1e-3],
    ])
    row = np.concatenate([
        rng.uniform(-2, H + 1, 40), [0.5, 2.5, -0.5, H - 0.5, 1.5, H - 1.5, 0.0, H - 1.0, H, H - 1e-3],
    ])
    return col.astype(np.float32), row.astype(np.float32)


@pytest.mark.parametrize("kind", ["nearest", "bilinear"])
def test_sampling(kind):
    H, W = 9, 11
    img = np.random.default_rng(6).random((H, W)).astype(np.float32)
    col, row = _coords(H, W)
    tf = twarp.sample_nearest if kind == "nearest" else twarp.sample_bilinear
    jf = jwarp.sample_nearest if kind == "nearest" else jwarp.sample_bilinear
    tv, tin = tf(_t(img), _t(col), _t(row))
    jv, jin = jf(jnp.asarray(img), jnp.asarray(col), jnp.asarray(row))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    _close(tv, jv)


# --- residuals and normal equations ------------------------------------


@pytest.fixture(scope="module")
def level_images(intr):
    """Source/target images and gradients of a 96x128 pair at level 1."""
    I0, D0, I1, _, _ = make_pair(tcam.Intrinsics(*(float(v) for v in intr)), shape=(96, 128))
    out = {}
    for name, img in (("si", I0), ("sd", D0), ("ti", I1)):
        out[name] = np.asarray(jpyr.build_pyramid(jnp.asarray(img), 2, None)[1])
    gx, gy = jpyr.build_gradient_pyramid([jnp.asarray(out["ti"])], (0.125,))
    out["gx"], out["gy"] = np.asarray(gx[0]), np.asarray(gy[0])
    return out


def test_jacobian_pieces(intr, states):
    D = np.random.default_rng(8).uniform(0.5, 4.0, (6, 8)).astype(np.float32)
    pts = np.asarray(jcam.backproject(jnp.asarray(D), intr))
    _close(tres.rigid_jacobian(_t(pts), _t(states[2])),
           jres.rigid_jacobian(jnp.asarray(pts), jnp.asarray(states[2])))
    ti = _torch_intr(intr)
    _close(tres.projection_jacobian(_t(pts), ti), jres.projection_jacobian(jnp.asarray(pts), intr),
           scaled=True)
    tw = tres.warp_and_jacobian(_t(D), _t(states[2] * 0.1), ti, 0.3, 5.0)
    jw = jres.warp_and_jacobian(jnp.asarray(D), jnp.asarray(states[2] * 0.1), intr, 0.3, 5.0)
    for a, b in zip(tw[:4], jw[:4]):
        _close(a, b, scaled=True)
    np.testing.assert_array_equal(tw[4].numpy(), np.asarray(jw[4]))


@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
@pytest.mark.parametrize("robust", ["none", "huber"])
def test_residuals_and_normal_equations(intr, level_images, states, sampling, robust):
    li = level_images
    intr1 = intr.at_level(1)
    state = states[0] * 0.05
    targs = [_t(li[k]) for k in ("si", "sd", "ti", "gx", "gy")]
    r, J, v = tres.photometric_residual_jacobian(
        *targs, _t(state), _torch_intr(intr1), sampling=sampling
    )
    jr, jJ, jv = jres.photometric_residual_jacobian(
        *(jnp.asarray(li[k]) for k in ("si", "sd", "ti", "gx", "gy")),
        jnp.asarray(state), intr1, sampling=sampling,
    )
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    _close(r, jr)
    _close(J, jJ, scaled=True)
    ne = tres.normal_equations(r, J, v, robust, 0.05)
    jne = jres.normal_equations(jr, jJ, jv, robust, 0.05)
    for a, b in zip(ne, jne[:4]):
        _close(a, b, scaled=True)
