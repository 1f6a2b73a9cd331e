"""Per-level setting schedule (torch port of phovo_tpu/utils/config.py).

The same fields and defaults as phovo_tpu's PhovoConfig, so one schedule
can drive both packages: PhovoConfig.from_dict(dataclasses.asdict(cfg))
carries a phovo_tpu config across. Lists are indexed by pyramid level;
levels with max_iterations 0 are skipped (state passes through).
"""

from __future__ import annotations

import dataclasses

from phovo_tpu_torch.ops.robust import LOSSES


@dataclasses.dataclass(frozen=True)
class PhovoConfig:
    num_levels: int = 5
    blur_filter_sizes: tuple[int, ...] = (0, 0, 0, 0, 0)
    blur_type: str = "gaussian"  # 'gaussian' (sigma 3) | 'box', applied twice
    gradient_scales: tuple[float, ...] = (0.0625,) * 5
    max_iterations: tuple[int, ...] = (0, 0, 5, 20, 50)
    visualize_iterations: bool = False
    min_depth: float = 0.3
    max_depth: float = 5.0
    # Gauss-Newton (analytic / bi-objective)
    lambda_steps: tuple[float, ...] = (1.0,) * 5
    min_gradient_norms: tuple[float, ...] = (300.0,) * 5
    # Trust-region (autodiff / "ceres")
    function_tolerances: tuple[float, ...] | None = None
    gradient_tolerances: tuple[float, ...] | None = None
    parameter_tolerances: tuple[float, ...] | None = None
    initial_trust_region_radii: tuple[float, ...] | None = None
    max_trust_region_radii: tuple[float, ...] | None = None
    min_trust_region_radii: tuple[float, ...] | None = None
    min_relative_decreases: tuple[float, ...] | None = None
    num_threads: int = 1
    num_linear_solver_threads: int = 1
    progress_to_stdout: bool = False
    sampling: str = "nearest"  # 'nearest' | 'bilinear'
    gradient_at: str = "warped"  # 'warped' | 'source' | 'esm'
    robust_loss: str = "none"  # one of ops.robust.LOSSES
    robust_delta: float = 0.1
    # sampling-matmul precision of the TPU kernels; the port computes in f32
    # whatever it says
    mix_mode: str = "bf16x2g"

    def validate(self) -> "PhovoConfig":
        for f in (
            "blur_filter_sizes", "gradient_scales", "max_iterations",
            "lambda_steps", "min_gradient_norms",
        ):
            v = getattr(self, f)
            if v is not None and len(v) != self.num_levels:
                raise ValueError(
                    f"{f} has {len(v)} entries, expected num_levels={self.num_levels}"
                )
        choices = {
            "robust_loss": LOSSES,
            "sampling": ("nearest", "bilinear"),
            "gradient_at": ("warped", "source", "esm"),
            "blur_type": ("gaussian", "box"),
            "mix_mode": ("f32", "bf16x2g", "bf16x2", "bf16"),
        }
        for f, allowed in choices.items():
            if getattr(self, f) not in allowed:
                raise ValueError(
                    f"{f}={getattr(self, f)!r}; expected one of {allowed}"
                )
        return self

    @classmethod
    def from_dict(cls, d: dict) -> "PhovoConfig":
        """Config from field names to values (lists become tuples); an
        unknown field raises, so a schedule is never half carried over."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - names)
        if unknown:
            raise ValueError(f"unknown PhovoConfig fields: {unknown}")
        kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        return cls(**kwargs).validate()
