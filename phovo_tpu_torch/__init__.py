"""phovo_tpu_torch — the PyTorch/CUDA port of phovo_tpu.

Multiscale photoconsistency visual odometry (6-DoF motion between
consecutive RGB-D frames by coarse-to-fine photometric Gauss-Newton) on an
NVIDIA H100. The JAX package phovo_tpu beside it is the reference this
package is tested against; this one imports torch and numpy and never jax.

Layout mirrors phovo_tpu:
  ops/      SE(3), camera, pyramids, warping, residuals, robust weights,
            the kernel wrappers (ops/fused_batch.py, ops/fused.py,
            ops/ic.py, ops/ic_batch.py) and their nvcc build
            (ops/_build.py)
  csrc/     the hand-written CUDA kernels
  solvers/  the exact per-pair Gauss-Newton and trust-region solvers
  models/   the analytic Gauss-Newton backend (align_analytic,
            PhotoconsistencyOdometryAnalytic, align_sequence,
            align_sequence_chunk), the trust-region ("ceres") backend
            (align_autodiff, align_sequence_autodiff,
            align_sequence_chunk_autodiff, PhotoconsistencyOdometryAutodiff),
            the bi-objective (intensity + depth) backend
            (align_biobjective, align_sequence_biobjective,
            align_sequence_chunk_biobjective,
            PhotoconsistencyOdometryBiObjective), the
            inverse-compositional backend (align_ic, align_sequence_ic,
            align_sequence_chunk_ic, PhotoconsistencyOdometryIC),
            and keyframe tracking with loop closures
            (models/keyframe.py, KeyframeVisualOdometry)
  parallel/ single-device batched alignment and multi-stream serving
            (parallel/batch.py), the pose graph (parallel/pose_graph.py)
            and the bundle adjustment, reprojection and photometric
            (parallel/bundle_adjustment.py, parallel/photometric_ba.py)
  datasets/ TUM sequences (index files, pairing, the cv2 reader), the raw
            memmap replay format and the libpng loader's bindings
  apps/     the CLIs, run as python -m phovo_tpu_torch.apps.<name>:
            phovo_vo, phovo_align, phovo_eval, phovo_convert and
            single-card phovo_serve (the card unless --device names
            another)
  utils/    config schedule and its YAML reader (no pyyaml), synthetic
            frames (the plane and the room), trajectories with ATE and
            RPE, JSONL metrics, the landmark map as PLY (utils/viz.py)
"""

__version__ = "0.1.0"

import torch as _torch

# The 6x6 normal equations sum products over up to 300k pixels, and TF32
# keeps ~3 decimal digits, enough to corrupt the Jacobians (phovo_tpu forces
# highest matmul precision for the same reason). Keep every float32
# matmul and convolution in full float32.
_torch.backends.cudnn.allow_tf32 = False
_torch.backends.cuda.matmul.allow_tf32 = False

from phovo_tpu_torch.ops import camera, fused_batch, pyramid, residuals, se3, warp  # noqa: E402,F401
from phovo_tpu_torch.utils.config import PhovoConfig, load_config  # noqa: E402,F401
from phovo_tpu_torch.models.base import AlignmentResult  # noqa: E402,F401
from phovo_tpu_torch.models.analytic import (  # noqa: E402,F401
    PhotoconsistencyOdometryAnalytic,
    align_analytic,
    align_sequence,
    align_sequence_chunk,
)
from phovo_tpu_torch.models.autodiff import (  # noqa: E402,F401
    PhotoconsistencyOdometryAutodiff,
    align_autodiff,
    align_sequence_autodiff,
    align_sequence_chunk_autodiff,
)
from phovo_tpu_torch.models.biobjective import (  # noqa: E402,F401
    PhotoconsistencyOdometryBiObjective,
    align_biobjective,
    align_sequence_biobjective,
    align_sequence_chunk_biobjective,
)
from phovo_tpu_torch.models.ic import (  # noqa: E402,F401
    PhotoconsistencyOdometryIC,
    align_ic,
    align_sequence_chunk_ic,
    align_sequence_ic,
)
from phovo_tpu_torch.models import BACKENDS  # noqa: E402,F401
