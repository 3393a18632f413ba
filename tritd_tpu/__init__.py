"""tritd_tpu — robust Triple Tensor Decomposition (TriTD) with ADMM, in JAX.

A from-scratch JAX/XLA framework, run on a GPU, with the capabilities of the
reference MATLAB research code (dangnq2501/Triple-Tensor-Decomposition-with-
ADMM): factor a corrupted/incomplete 3-way tensor D into a low-rank triple
product L = TriTD(A, B, C) of three coupled 3-way cores plus a sparse outlier
part O, via a two-constraint ADMM with l1 soft-thresholding and ridge
Gram solves — plus the reference's experiment protocol, metrics suite, and
JAX reimplementations of its four comparison baselines.

Layer map (mirrors SURVEY §1):
  ops/       L0 tensor-ops kernels (folds, designs, normal equations, prox)
  solvers/   L1 first-party solvers (ADMM, ALS, MALS, nonconvex outlier)
  baselines/ L2 comparison methods (TT-TRPCA, RC-FCTN, RTRC, SOFIA)
  cli/       L3 experiment drivers (completion, video)
  metrics/   L4 evaluation (RRE/RMSE, PSNR/SSIM, F1/PWC/mAP)
  parallel/  multi-chip sharding (mesh, shard_map ADMM with psum'd Grams)
  data/      synthetic generators + .mat dataset ingest
  utils/     config presets, artifacts, checkpointing, timing
  runtime/   native C++ kernels (proximal ops) behind ctypes
"""

__version__ = "0.1.0"

from . import ops, solvers
from .solvers import (
    TriTDConfig,
    TriTDResult,
    tritd_admm,
    tritd_als,
    tritd_mals,
    tritd_admm_outlier,
    OutlierConfig,
)
from .ops import triple_product, soft_threshold

__all__ = [
    "ops",
    "solvers",
    "TriTDConfig",
    "TriTDResult",
    "tritd_admm",
    "tritd_als",
    "tritd_mals",
    "tritd_admm_outlier",
    "OutlierConfig",
    "triple_product",
    "soft_threshold",
]
