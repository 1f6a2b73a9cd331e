"""The port's multi-rank forms on the CPU, in spawned gloo ranks: the
analogues of tests/test_parallel.py and __graft_entry__.py::dryrun_multichip.

parallel/mesh.py and distributed.py, the data axis of parallel/batch.py
(make_data_parallel_aligner with an odd B, make_multi_sequence_server,
align_sequences_levelmajor_sharded, make_chunked_sequence_server on both
routes), the pixel axis of parallel/sharded_ne.py (the normal equations and
the aligner), and the flattened mesh of optimize_pose_graph (dense, CG),
optimize_bundle (dense, sparse), optimize_photometric_bundle (a window, a
global problem) and finalize(mesh=) (window and global BA at damping 1.0).

Each world size, 1, 2 and 4, is spawned once for the module
(distributed.spawn_ranks, a file rendezvous in a fresh directory); every
rank runs every case on every mesh shape (data, pixel) of its world and
returns its results, which must be every other rank's, bit for bit. This
module imports jax only inside its tests: the ranks import it to find
their worker.

Held, each case on each mesh shape:
  * against the port's unsharded call (the same form on a one-rank mesh,
    which is the single-device code): bit for bit on the exact per-pair
    route (use_fused=False) and wherever a rank computes whole pairs or
    streams alone (the chunked server's 'off' route); within 1e-6 where
    the level kernel's plain version sums over a batch that the sharding
    cuts (its sums round with the batch); the all-reduced forms (pixel and
    flattened) within 1e-5, relative and absolute, as the dryrun's check;
  * against phovo_tpu's same form on the case's last (4-rank) mesh shape
    over its 8 virtual CPU devices (one shape a case: phovo_tpu compiles
    a program for each mesh, seconds a call here), at the tolerances the
    single-device port tests hold that entry to: alignment states 2e-4,
    iterations and valid counts equal, costs 1e-4 relative, 2e-3 against
    a batched route (tests/test_torch_serving.py); the normal equations
    1e-4 of their largest entry; pose graphs 1e-5
    (tests/test_torch_pose_graph.py); the reprojection BA 5e-5
    (tests/test_torch_bundle_adjustment.py); the photometric BA and
    finalize at damping 1.0 1e-5 (tests/test_torch_photometric_ba.py).
"""

import functools

import numpy as np
import pytest
import torch

from phovo_tpu_torch.models.analytic import PhotoconsistencyOdometryAnalytic
from phovo_tpu_torch.models.keyframe import Keyframe, KeyframeVisualOdometry
from phovo_tpu_torch.ops import pyramid as pyr
from phovo_tpu_torch.ops import se3
from phovo_tpu_torch.ops.camera import TUM_DEFAULT, Intrinsics
from phovo_tpu_torch.parallel import batch as tbatch
from phovo_tpu_torch.parallel import bundle_adjustment as TB
from phovo_tpu_torch.parallel import distributed
from phovo_tpu_torch.parallel import photometric_ba as TP
from phovo_tpu_torch.parallel import pose_graph as tpg
from phovo_tpu_torch.parallel.mesh import Mesh, make_mesh
from phovo_tpu_torch.parallel.sharded_ne import make_pixel_sharded_aligner, sharded_normal_equations
from phovo_tpu_torch.utils.config import PhovoConfig
from phovo_tpu_torch.utils.synthetic import make_sequence, render_plane, render_room

torch.set_num_threads(1)

SHAPE = (48, 64)  # level 1 24x32: both heights divide by 4
INTR = Intrinsics(64.0, 64.0, 31.5, 23.5)
CFG = dict(num_levels=2, blur_filter_sizes=(0, 0), gradient_scales=(0.0625,) * 2, max_iterations=(2, 3),
           lambda_steps=(1.0,) * 2, min_gradient_norms=(0.0,) * 2, sampling="bilinear")
B_ODD = 5  # pairs: the data axis of 2 and 4 pads it
S, T = 4, 3  # streams, frames a stream
DEPTH_SCALE = 1.0 / 5000.0
BA_KW = dict(iterations=2, damping=1.0)
KF_SHAPE, N_KF = (48, 64), 5
FINALIZE_KW = dict(ba_iterations=2, ba_window=3, ba_grid=4, ba_covis=2, ba_damping=1.0)

DATA = [(1, 1), (2, 1), (4, 1), (2, 2)]
PIXEL = [(1, 1), (1, 2), (2, 2), (1, 4)]
FLAT = [(1, 1), (2, 1), (2, 2)]
# case: (mesh shapes, held to the unsharded call by)
CASES = {
    "dp": (DATA, "bits"), "dp_fused": (DATA, "batched"), "multi": (DATA, "batched"),
    "levelmajor": (DATA, "batched"), "chunked_auto": (DATA, "batched"), "chunked_off": (DATA, "bits"),
    "ne": (PIXEL, "reduced"), "pixel": (PIXEL, "reduced"),
    "pg_dense": (FLAT, "reduced"), "pg_cg": (FLAT, "reduced"), "ba_dense": (FLAT, "reduced"),
    "ba_sparse": (FLAT, "reduced"), "pba_window": (FLAT, "reduced"), "pba_global": (FLAT, "reduced"),
    "finalize_window": (FLAT, "reduced"), "finalize_global": (FLAT, "reduced"),
}
WORLDS = (1, 2, 4)


# -- the inputs (numpy, made once from seeds; the ranks rebuild tensors) ------


def _streams(n, t, seed):
    """n make_sequence streams of t frames at SHAPE, a 4-pixel depth-less
    border (the bilinear edge at u = 0 rounds apart in the two packages)."""
    I, D = [], []
    for k in range(n):
        Ik, Dk, _, _ = make_sequence(INTR, SHAPE, t, seed=seed + k)
        I.append(np.stack(Ik))
        D.append(np.stack(Dk))
    I, D = np.stack(I), np.stack(D)
    D[..., :4, :] = D[..., -4:, :] = 0.0
    D[..., :4] = D[..., -4:] = 0.0
    return np.round(I * 255.0).astype(np.uint8), D.astype(np.float32)


def _keyframes():
    """N_KF room keyframes at noisy poses, their odometry edges measured
    from the truth: (intensities, depths, world<-keyframe poses, edges)."""
    H, W = KF_SHAPE
    fx = 525.0 * W / 640.0
    intr = Intrinsics(fx, fx, (W - 1) / 2, (H - 1) / 2)
    rng = np.random.default_rng(3)
    gt = np.zeros((N_KF, 6))
    gt[:, 0] = np.linspace(0.0, 0.4, N_KF)
    gt[:, 3] = np.linspace(0.0, 0.15, N_KF)
    I, D, poses = [], [], []
    for m in range(N_KF):
        a, b = render_room(intr, KF_SHAPE, se3.pose_matrix_np(gt[m]))
        noisy = gt[m] + (np.concatenate([rng.normal(0, 0.01, 3), rng.normal(0, 0.005, 3)]) if m else 0.0)
        I.append(a)
        D.append(b)
        poses.append(np.linalg.inv(se3.pose_matrix_np(noisy)))
    world = [np.linalg.inv(se3.pose_matrix_np(g)) for g in gt]
    edges = [(m, m + 1, np.linalg.inv(world[m]) @ world[m + 1]) for m in range(N_KF - 1)]
    return intr, np.stack(I), np.stack(D), poses, edges


def _make_inputs():
    si, sd = _streams(B_ODD, 2, seed=20)
    init = (np.random.default_rng(3).standard_normal((B_ODD, 6)) * 2e-3).astype(np.float32)
    I, D = _streams(S, T, seed=30)
    D16 = np.round(D / DEPTH_SCALE).astype(np.uint16)
    rel = (np.array([0.1, 0.02, -0.01, 0.05, -0.02, 0.01])
           + 0.01 * np.random.default_rng(5).standard_normal((7, 6))).astype(np.float32)
    graph = tpg.chain_to_graph(torch.from_numpy(rel), [(0, 7, np.zeros(6, np.float32))], loop_weight=10.0)
    ba, _, _ = TB.make_synthetic_ba(n_poses=3, n_points=12, seed=0)
    pl_states = np.zeros((3, 6), np.float32)
    pl_states[:, 0] = np.linspace(0.0, 0.06, 3)
    pl = [render_plane(INTR, SHAPE, np.linalg.inv(se3.pose_matrix_np(s.astype(np.float64)))) for s in pl_states]
    pl_I, pl_D = np.stack([a for a, _ in pl]), np.stack([b for _, b in pl])
    return dict(
        pairs=(si[:, 0], sd[:, 0], si[:, 1], sd[:, 1], init), streams=(I, D, D16),
        pair=((I[0, 0] / 255.0).astype(np.float32), D[0, 0], (I[0, 1] / 255.0).astype(np.float32), D[0, 1]),
        state=np.array([0.01, -0.01, 0.005, 0.004, -0.003, 0.002], np.float32),
        graph=tuple(x.numpy() for x in graph), ba=tuple(ba),
        plane=(pl_I, pl_D, pl_states), keyframes=_keyframes(),
    )


# -- the forms, run the same way in the ranks and on a one-rank mesh here -----


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _kvo(inputs):
    """The port's tracker on the CPU holding the keyframes and odometry
    edges of inputs['keyframes']."""
    intr, I, D, poses, edges = inputs["keyframes"]
    vo = PhotoconsistencyOdometryAnalytic(PhovoConfig(**CFG), device="cpu")
    vo.set_intrinsic_matrix([[intr.fx, 0, intr.cx], [0, intr.fy, intr.cy], [0, 0, 1]])
    kvo = KeyframeVisualOdometry(vo)
    for m in range(len(I)):
        kvo.keyframes.append(Keyframe(index=m, frame_index=m, timestamp=float(m), intensity=I[m], depth=D[m],
                                      pose=poses[m].copy(), device="cpu"))
    kvo.odometry_edges = [(i, j, rel.copy()) for i, j, rel in edges]
    return kvo


def _plane_problem(inputs, scope):
    I, D, states = inputs["plane"]
    if scope == "window":
        return TP.build_photometric_window(I, D, states, INTR, grid=4, device="cpu")
    return TP.build_photometric_global(I, D, states, INTR, grid=4, max_covis=2, device="cpu")


def run_case(case, mesh, inputs):
    """One form on `mesh`: the same global inputs on every rank."""
    cfg = PhovoConfig(**CFG)
    if case in ("dp", "dp_fused"):
        *frames, init = inputs["pairs"]
        align = tbatch.make_data_parallel_aligner(mesh, cfg, use_fused=case == "dp_fused")
        return align(*map(_t, frames), INTR, _t(init))
    I, D, D16 = inputs["streams"]
    if case == "multi":
        return tbatch.make_multi_sequence_server(mesh, cfg)(_t(I), _t(D), INTR)
    if case == "levelmajor":
        return tbatch.align_sequences_levelmajor_sharded(_t(I), _t(D), INTR, cfg, mesh)
    if case.startswith("chunked"):
        serve = tbatch.make_chunked_sequence_server(mesh, cfg, depth_scale=DEPTH_SCALE,
                                                    levelmajor=case.split("_")[1])
        carry_d = _t(D16[:, 0]).to(torch.float32) * float(np.float32(DEPTH_SCALE))
        return serve(_t(I[:, 0]), carry_d, _t(I[:, 1:]), _t(D16[:, 1:]), INTR)
    si, sd, ti, td = map(_t, inputs["pair"])
    if case == "ne":
        gx, gy = pyr.scharr(ti, "x", 0.0625), pyr.scharr(ti, "y", 0.0625)
        return sharded_normal_equations(mesh, si, sd, ti, gx, gy, _t(inputs["state"]), INTR, 0.3, 5.0, "bilinear")
    if case == "pixel":
        return make_pixel_sharded_aligner(mesh, cfg)(si, sd, ti, td, INTR, torch.zeros(6))
    if case.startswith("pg"):
        graph = tpg.PoseGraph(*map(_t, inputs["graph"]))
        return tpg.optimize_pose_graph(graph, mesh=mesh, iterations=3, damping=1e-4, solver=case[3:],
                                       cg_iterations=150, cg_tol=1e-12, device="cpu")
    if case.startswith("ba"):
        return TB.optimize_bundle(TB.BAProblem(*inputs["ba"]), TUM_DEFAULT, mesh=mesh, schur=case[3:], device="cpu",
                                  **BA_KW)
    if case.startswith("pba"):
        return TP.optimize_photometric_bundle(_plane_problem(inputs, case[4:]), INTR, mesh=mesh, **BA_KW)
    kvo = _kvo(inputs)
    kvo.finalize(mesh=mesh, ba_scope=case.split("_")[1], **FINALIZE_KW)
    return np.stack([k.pose for k in kvo.keyframes]), kvo.map_points


def rank_cases(inputs):
    """Every case on every mesh shape of this rank's world (ranks enter
    make_mesh in the same order); {(case, shape): result}."""
    import torch.distributed as dist

    n = dist.get_world_size()
    out = {}
    for shape in sorted({s for shapes, _ in CASES.values() for s in shapes if s[0] * s[1] == n}):
        mesh = make_mesh(n, pixel_parallel=shape[1], devices=["cpu"] * n)
        for case, (shapes, _) in CASES.items():
            if shape in shapes:
                out[case, shape] = run_case(case, mesh, inputs)
        if shape == (1, 4):  # a 30x40 frame: level 1 has 15 rows, which 4 pixel ranks do not divide
            img = torch.ones((30, 40))
            try:
                make_pixel_sharded_aligner(mesh, PhovoConfig(**CFG))(img, img, img, img, INTR, torch.zeros(6))
            except ValueError as e:
                out["pixel_30"] = str(e)
    return out


# -- fixtures --------------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs():
    return _make_inputs()


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [a for y in x for a in _leaves(y)]
    return [np.asarray(x)]


@pytest.fixture(scope="module")
def sharded(inputs, tmp_path_factory):
    """{(case, shape): rank 0's result}; every rank's result the same bits.
    The three worlds run at once."""
    from concurrent.futures import ThreadPoolExecutor

    stores = {n: tmp_path_factory.mktemp(f"world{n}") / "store" for n in WORLDS}

    def world(n):
        return distributed.spawn_ranks(rank_cases, n, f"file://{stores[n]}", args=(inputs,))

    with ThreadPoolExecutor(len(WORLDS)) as pool:
        worlds = list(pool.map(world, WORLDS))
    out = {}
    for results in worlds:
        for rank, res in enumerate(results[1:], 1):
            assert res.keys() == results[0].keys(), rank
            for key in res:
                assert all(np.array_equal(a, b, equal_nan=a.dtype.kind == "f") for a, b in
                           zip(_leaves(res[key]), _leaves(results[0][key]))), (rank, key)
        out.update(results[0])
    return out


@functools.lru_cache(maxsize=None)
def _unsharded(case):
    return distributed.to_numpy(run_case(case, make_mesh(1, devices=["cpu"]), _make_inputs()))


def _params():
    return [pytest.param(case, shape, id=f"{case}-{shape[0]}x{shape[1]}")
            for case, (shapes, _) in CASES.items() for shape in shapes]


# -- phovo_tpu's forms on its 8 virtual CPU devices -------------------------------

# phovo_tpu's level-major and chunked 'interpret' routes run its Pallas
# kernels in interpret mode (~35 s a call here): the port's level-major forms
# are held to its XLA routes over the same pairs instead, as
# tests/test_parallel.py holds its two routes to each other
JAX_FORM = {"dp_fused": "dp", "levelmajor": "multi", "chunked_auto": "chunked_off"}
# tests/test_torch_serving.py's cost bound against a batched route
# (MULTI_COST_RTOL): costs near convergence, ~1e-6 a pixel
MULTI_COST_RTOL = 2e-3


@functools.lru_cache(maxsize=None)
def _jax_case(case, shape):
    """phovo_tpu's form of `case` on a (data, pixel) mesh of its virtual
    devices, on _make_inputs(), as numpy."""
    import jax
    import jax.numpy as jnp

    from phovo_tpu.ops.camera import Intrinsics as JIntrinsics
    from phovo_tpu.ops.camera import TUM_DEFAULT as J_TUM
    from phovo_tpu.parallel import batch as jbatch
    from phovo_tpu.parallel import bundle_adjustment as JB
    from phovo_tpu.parallel import photometric_ba as JP
    from phovo_tpu.parallel import pose_graph as jpg
    from phovo_tpu.parallel.mesh import make_mesh as jmake_mesh
    from phovo_tpu.parallel.sharded_ne import make_pixel_sharded_aligner as jpixel
    from phovo_tpu.parallel.sharded_ne import sharded_normal_equations as jne
    from phovo_tpu.utils.config import PhovoConfig as JConfig

    inputs = _make_inputs()
    mesh = jmake_mesh(shape[0] * shape[1], pixel_parallel=shape[1])
    cfg, jintr = JConfig(**CFG), JIntrinsics(*(np.float32(v) for v in INTR))

    def host(x):
        return jax.tree.map(np.asarray, jax.device_get(x))

    if case == "dp":
        *frames, init = inputs["pairs"]
        return host(jbatch.make_data_parallel_aligner(mesh, cfg)(*map(jnp.asarray, frames), jintr, jnp.asarray(init)))
    I, D, D16 = inputs["streams"]
    if case == "multi":
        serve = jbatch.make_multi_sequence_server(mesh, cfg, use_fused=False)
        return host(serve(jnp.asarray(I), jnp.asarray(D), jintr))
    if case == "chunked_off":
        serve = jbatch.make_chunked_sequence_server(mesh, cfg, depth_scale=DEPTH_SCALE, levelmajor="off")
        carry_d = jnp.asarray(D16[:, 0]).astype(jnp.float32) * jnp.float32(DEPTH_SCALE)
        return host(serve(jnp.asarray(I[:, 0]), carry_d, jnp.asarray(I[:, 1:]), jnp.asarray(D16[:, 1:]), jintr))
    si, sd, ti, td = map(jnp.asarray, inputs["pair"])
    if case == "ne":
        gx, gy = (jnp.asarray(pyr.scharr(_t(inputs["pair"][2]), a, 0.0625).numpy()) for a in ("x", "y"))
        ne = jax.jit(lambda *a: jne(mesh, *a, jintr, 0.3, 5.0, "bilinear"))
        return host(ne(si, sd, ti, gx, gy, jnp.asarray(inputs["state"])))
    if case == "pixel":
        return host(jpixel(mesh, cfg)(si, sd, ti, td, jintr, jnp.zeros(6)))
    if case.startswith("pg"):
        return host(jpg.optimize_pose_graph(jpg.PoseGraph(*inputs["graph"]), mesh=mesh, iterations=3, damping=1e-4,
                                            solver=case[3:], cg_iterations=150, cg_tol=1e-12))
    if case.startswith("ba"):
        return host(JB.optimize_bundle(JB.BAProblem(*map(jnp.asarray, inputs["ba"])), J_TUM, mesh=mesh,
                                       schur=case[3:], **BA_KW))
    if case.startswith("pba"):
        pI, pD, states = inputs["plane"]
        build = JP.build_photometric_window if case == "pba_window" else functools.partial(
            JP.build_photometric_global, max_covis=2)
        return host(JP.optimize_photometric_bundle(build(pI, pD, states, jintr, grid=4), jintr, mesh=mesh, **BA_KW))
    return _jax_finalize(case.split("_")[1], mesh, inputs)


def _jax_finalize(scope, mesh, inputs):
    from phovo_tpu.models.analytic import PhotoconsistencyOdometryAnalytic as JAnalytic
    from phovo_tpu.models.keyframe import Keyframe as JKeyframe
    from phovo_tpu.models.keyframe import KeyframeVisualOdometry as JKVO
    from phovo_tpu.utils.config import PhovoConfig as JConfig

    intr, I, D, poses, edges = inputs["keyframes"]
    vo = JAnalytic(JConfig(**CFG))
    vo.set_intrinsic_matrix(np.array([[intr.fx, 0, intr.cx], [0, intr.fy, intr.cy], [0, 0, 1]], np.float32))
    kvo = JKVO(vo)
    for m in range(len(I)):
        kvo.keyframes.append(JKeyframe(index=m, frame_index=m, timestamp=float(m), intensity=I[m], depth=D[m],
                                       pose=poses[m].copy()))
    kvo.odometry_edges = [(i, j, rel.copy()) for i, j, rel in edges]
    kvo.finalize(mesh=mesh, ba_scope=scope, **FINALIZE_KW)
    return np.stack([k.pose for k in kvo.keyframes]), kvo.map_points


# -- the tests ------------------------------------------------------------------------


def _alignment(res):
    """The AlignmentResult of a form's result (the servers return it
    first)."""
    return res if hasattr(res, "_fields") else res[0]


def _assert_alignment_close(got, ref, case, state_atol, cost_rtol, cost_atol):
    res, ref_res = _alignment(got), _alignment(ref)
    np.testing.assert_allclose(res.state, ref_res.state, rtol=0, atol=state_atol, err_msg=case)
    np.testing.assert_array_equal(res.iterations, ref_res.iterations, err_msg=case)
    np.testing.assert_array_equal(res.num_valid, ref_res.num_valid, err_msg=case)
    for a, b in ((res.cost, ref_res.cost), (res.gradient_norm, ref_res.gradient_norm)):
        np.testing.assert_allclose(a, b, rtol=cost_rtol, atol=cost_atol, err_msg=case)
    if res is not got and ref is not ref_res:  # the servers' poses and carries
        for a, b in zip(_leaves(got[1:]), _leaves(ref[1:])):
            np.testing.assert_allclose(a, b, rtol=0, atol=state_atol, err_msg=case)


@pytest.mark.parametrize("case,shape", _params())
def test_mesh_form_matches_unsharded(sharded, case, shape):
    """Every rank's result of the form on `shape` against the unsharded
    call: the same bits on one rank and on the 'bits' routes; states and
    poses within 1e-6 on the 'batched' routes (costs and gradient norms,
    near convergence, 1e-4 relative); the all-reduced forms within 1e-5
    (alignment costs 1e-5 relative or 1e-3 absolute, the dryrun's check; a
    solver's last cost 1e-5 relative or 1e-4 absolute, the dryrun's
    pose-graph check)."""
    got, how = sharded[case, shape], CASES[case][1]
    ref = _unsharded(case)
    assert [a.shape for a in _leaves(got)] == [a.shape for a in _leaves(ref)]
    if how == "bits" or shape[0] * shape[1] == 1:
        for a, b in zip(_leaves(got), _leaves(ref)):
            np.testing.assert_array_equal(a, b, err_msg=case)
    elif how == "batched":
        _assert_alignment_close(got, ref, case, 1e-6, 1e-4, 1e-9)
    elif case == "pixel":
        _assert_alignment_close(got, ref, case, 1e-5, 1e-5, 1e-3)
    elif case == "ne":
        for a, b in zip(got[:4], ref[:4]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(1.0, np.abs(b).max()), err_msg=case)
    else:
        *fields, cost = _leaves(got)
        *ref_fields, ref_cost = _leaves(ref)
        for a, b in zip(fields, ref_fields):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=case)
        np.testing.assert_allclose(cost, ref_cost, rtol=1e-5, atol=1e-4, err_msg=case)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_form_matches_phovo_tpu(sharded, case):
    """The form on its last mesh shape (4 ranks) against phovo_tpu's form
    on that shape of its virtual devices (the level-major forms against
    its XLA routes, JAX_FORM), at the single-device port tests'
    tolerances."""
    shape = CASES[case][0][-1]
    got, ref = sharded[case, shape], _jax_case(JAX_FORM.get(case, case), shape)
    if case in ("dp", "pixel", "chunked_off"):
        _assert_alignment_close(got, ref, case, 2e-4, 1e-4, 1e-9)
    elif case in ("dp_fused", "multi", "levelmajor", "chunked_auto"):
        _assert_alignment_close(got, ref, case, 2e-4, MULTI_COST_RTOL, 1e-9)
    elif case == "ne":
        for a, b in zip(got[:4], ref[:4]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * max(1.0, np.abs(b).max()), err_msg=case)
    elif case.startswith("pg"):
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-5, err_msg=case)
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-4, atol=1e-8, err_msg=case)
    elif case.startswith("ba_"):
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=5e-5, err_msg=case)
        np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=5e-5, err_msg=case)
    elif case.startswith("pba"):
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-5, err_msg=case)
        np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-5, err_msg=case)
    else:  # finalize: the keyframe poses and the map's size
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-5, err_msg=case)
        assert len(got[1]) == len(ref[1]) > 0, case


def test_one_rank_mesh_forms_are_the_single_device_calls(inputs):
    """A one-rank mesh runs the single-device code: the data-parallel
    aligner is align_batch, the pixel-sharded aligner on the exact route is
    align_analytic's (use_fused=False, 'warped', no robust loss)."""
    from phovo_tpu_torch.models.analytic import align_analytic

    cfg = PhovoConfig(**CFG)
    *frames, init = inputs["pairs"]
    ref = tbatch.align_batch(*map(_t, frames), INTR, _t(init), cfg, use_fused=False)
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(_unsharded("dp")), _leaves(distributed.to_numpy(ref))))
    ref = align_analytic(*map(_t, inputs["pair"]), INTR, torch.zeros(6), cfg, use_fused=False)
    for a, b in zip(_unsharded("pixel")[:5], distributed.to_numpy(ref)[:5]):
        np.testing.assert_array_equal(a, b)


def test_mesh_errors():
    """make_mesh(2) with no process group names both numbers; the pixel
    axis refuses a height it does not divide; a rank outside the mesh has
    no coordinates; the data axis refuses a stream count it does not
    divide."""
    with pytest.raises(ValueError, match="2 devices needs 2 ranks.*world size 1"):
        make_mesh(2)
    with pytest.raises(ValueError, match="not divisible by pixel_parallel"):
        make_mesh(3, pixel_parallel=2)
    one = make_mesh(1, devices=["cpu"])
    assert one.shape == {"data": 1, "pixel": 1} and one.coords == (0, 0) and one.size == 1
    assert distributed.initialize() is False and distributed.global_mesh().size == 1
    img = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="image height 48 is not divisible by the mesh 'pixel' axis size 5"):
        sharded_normal_equations(Mesh({"data": 1, "pixel": 5}, 0, one.device, {}), img, img, img, img, img,
                                 torch.zeros(6), INTR, 0.3, 5.0)
    with pytest.raises(ValueError, match="outside the mesh"):
        Mesh({"data": 2, "pixel": 1}, None, one.device, {}).coords
    with pytest.raises(ValueError, match="S=3 not divisible by data axis 2"):
        tbatch.align_sequences_levelmajor_sharded(torch.zeros((3, 2, *SHAPE)), torch.zeros((3, 2, *SHAPE)), INTR,
                                                  PhovoConfig(**CFG), Mesh({"data": 2, "pixel": 1}, 0, one.device, {}))


def test_pixel_height_the_axis_does_not_divide_raises_in_ranks(sharded):
    """On a real pixel axis of 4 ranks, a 30x40 frame raises phovo_tpu's
    ValueError at its first level (level 1: 15 rows) in every rank."""
    assert "image height 15 is not divisible by the mesh 'pixel' axis size 4" in sharded["pixel_30"]


def test_local_batch_slice():
    """phovo_serve's split of the streams: phovo_tpu's rule over the
    processes, over a mesh's data axis, and nothing for a rank outside the
    mesh."""
    dev = torch.device("cpu")
    assert distributed.local_batch_slice(6) == (0, 6)
    assert distributed.local_batch_slice(6, make_mesh(1, devices=[dev])) == (0, 6)
    assert distributed.local_batch_slice(6, Mesh({"data": 2, "pixel": 1}, 1, dev, {})) == (3, 3)
    assert distributed.local_batch_slice(6, Mesh({"data": 2, "pixel": 2}, 3, dev, {})) == (3, 3)
    assert distributed.local_batch_slice(6, Mesh({"data": 2, "pixel": 1}, None, dev, {})) == (0, 0)
