"""lbmpc_tpu_torch — the PyTorch/CUDA port of the learning-based MPC engine.

A second package beside the JAX reference (`lbmpc_tpu`), covering the LMPC,
LBMPC and NMPC controllers, the fused LBMPC SQP solve and the warm-chain
fleet closed loop:

- ``config``, ``synthesis``, ``sets``, ``controllers.condensed`` — host-side
  numpy setup (presets, matOCP synthesis, terminal sets, condensed QP);
- ``models`` — the plant ODE and its batched integrators in torch
  (``mgcm``), the implicit collocation step (``collocation``) and the DLTI
  containers (``linear``, numpy);
- ``oracle`` — the Nadaraya-Watson window and estimate in torch;
- ``controllers.lbmpc`` / ``controllers.sqp_fused`` — the Gauss-Newton SQP;
- ``controllers.nmpc`` — the NMPC (tracking and regulation) on the SQP with
  nonlinear constraints;
- ``ops`` — the two hand-written CUDA kernels (GN phase, Mehrotra QP) with
  their plain PyTorch versions;
- ``runtime`` — the batched closed loop and the fleet episode builder;
- ``interop`` — carrying the reference package's matrices across.

Entry points run on CUDA unless the caller passes a device (the tests pass
``device="cpu"``). Every float32 matrix product runs in full float32: the
reference runs at Precision.HIGHEST, so TF32 is switched off here.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from lbmpc_tpu_torch.config import (  # noqa: E402
    MGCMConfig,
    OCPConfig,
    OracleConfig,
    ScenarioConfig,
    SolverConfig,
    make_preset,
)
from lbmpc_tpu_torch.device import resolve_device  # noqa: E402

__version__ = "0.1.0"
