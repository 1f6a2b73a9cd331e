from phovo_tpu_torch.models.analytic import PhotoconsistencyOdometryAnalytic, align_analytic  # noqa: F401
from phovo_tpu_torch.models.autodiff import PhotoconsistencyOdometryAutodiff  # noqa: F401
from phovo_tpu_torch.models.base import AlignmentResult, PhotoconsistencyOdometryBase  # noqa: F401
from phovo_tpu_torch.models.biobjective import PhotoconsistencyOdometryBiObjective  # noqa: F401
from phovo_tpu_torch.models.ic import PhotoconsistencyOdometryIC  # noqa: F401

# Object-API backends by the names phovo_tpu's BACKENDS uses: all four of
# its odometry backends.
BACKENDS = {
    "analytic": PhotoconsistencyOdometryAnalytic,
    "autodiff": PhotoconsistencyOdometryAutodiff,
    "ceres": PhotoconsistencyOdometryAutodiff,  # reference naming alias
    "biobjective": PhotoconsistencyOdometryBiObjective,
    "ic": PhotoconsistencyOdometryIC,
}
