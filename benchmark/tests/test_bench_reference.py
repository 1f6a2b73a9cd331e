"""The plain reference against the port's CPU path at 60x80: the port's
plain twins write the same per-pixel arithmetic, so the batched replay
gives the reference's bits and a pair alone differs by the rounding of
its sums (a few pairs whose 4x5 level has almost no valid pixel carry it
far, so the typical answer is held there)."""

import numpy as np
import pytest

from benchmark.drivers import integrate
from benchmark.reference import vo
from benchmark.tests.helpers import small_run


@pytest.mark.parametrize("cell, exact", [("analytic5.replay", True), ("ceres5.replay", True),
                                         ("ceres5.live", False)])
def test_reference_agrees_with_the_port_on_the_cpu(cell, exact):
    rec = small_run(cell, seed=31, keep=True)
    n = rec["numbers"]
    assert n["answers"] > 10 and n["missing"] == 0
    if exact:
        assert n["state_gap"] == 0.0 and n["iters_differ"] == 0.0 and n["valid_gap"] == 0.0
    else:  # a pair alone sums in another order than the reference's blocks
        assert n["state_gap_median"] < 1e-6 and n["valid_gap"] == 0.0
    # the reference moved every pair: its states are no zero answer
    assert np.abs(rec["ref"][0]).max(axis=1).min() > 0


def test_harness_integration_matches_the_reference_loop():
    rng = np.random.default_rng(3)
    states = rng.normal(scale=0.05, size=(40, 6)).astype(np.float32)
    poses, last = integrate(np.eye(4), states)
    ref = vo.integrate(states)
    assert np.abs(poses - ref).max() < 1e-12
    assert np.array_equal(last, poses[-1])


def test_reference_resize_and_gradients_match_opencv_conventions():
    import torch

    img = torch.arange(48, dtype=torch.float32).reshape(1, 6, 8)
    half = vo.resize(img, (3, 4))
    assert torch.equal(half[0, 0], 0.5 * (0.5 * (img[0, 0, 0::2] + img[0, 0, 1::2])
                                          + 0.5 * (img[0, 1, 0::2] + img[0, 1, 1::2]))[:4])
    gx = vo.scharr(img, "x", 1.0)
    assert torch.allclose(gx[0, 2:-2, 2:-2], torch.full((2, 4), 32.0))
    gy = vo.scharr(img, "y", 1.0)
    assert torch.allclose(gy[0, 2:-2, 2:-2], torch.full((2, 4), 256.0))


def _analytic_cfg(**preset):
    from benchmark import check, run

    _, config, _, _ = run.cell_files(run.load_json(run.ROOT / "BENCHMARK.json"), "analytic5.replay")
    config["preset"].update(preset)
    return check.reference_config(config)


@pytest.mark.parametrize("change", [
    {"robust_loss": "huber"}, {"gradient_at": "esm"}, {"blur_filter_sizes": [0, 0, 3, 0, 0]},
    {"sampling": "bicubic"}, {"ic_levels": [1, 1, 1, 1, 1]},
])
def test_reference_refuses_a_preset_value_it_does_not_implement(change):
    with pytest.raises(ValueError):
        vo.solver(_analytic_cfg(**change))


@pytest.mark.parametrize("backend", ["ic", "vo", "../check"])
def test_reference_refuses_a_backend_it_has_no_solver_for(backend):
    cfg = _analytic_cfg()
    cfg["backend"] = backend
    with pytest.raises(ValueError):
        vo.solver(cfg)


def test_reference_follows_the_cells_configurations():
    from benchmark import check, run

    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        _, config, _, _ = run.cell_files(bench, w["name"])
        assert vo.solver(check.reference_config(config)).__name__.endswith(config["backend"])


@pytest.mark.parametrize("entry", ["chunk_entry", "object_api", "kernel_library"])
def test_program_refuses_an_entry_it_does_not_have(entry):
    import torch

    from benchmark import drivers, run

    _, config, _, _ = run.cell_files(run.load_json(run.ROOT / "BENCHMARK.json"), "ceres5.replay")
    config["program"][entry] = "phovo_tpu_torch.models.autodiff.no_such_entry"
    with pytest.raises(AttributeError):
        drivers.Program(config, torch.device("cpu"))
