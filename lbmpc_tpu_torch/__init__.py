"""lbmpc_tpu_torch — the PyTorch/CUDA port of the learning-based MPC engine.

A second package beside the JAX reference (`lbmpc_tpu`), covering the LMPC,
LBMPC and NMPC controllers, the fused LBMPC SQP solve, the warm-chain
fleet closed loop, checkpoints, profiling and the analysis layer:

- ``config``, ``synthesis``, ``sets``, ``controllers.condensed`` — host-side
  numpy setup (presets, matOCP synthesis, terminal sets, condensed QP);
- ``models`` — the plant ODE and its batched integrators in torch
  (``mgcm``), the implicit collocation step (``collocation``) and the DLTI
  containers (``linear``, numpy);
- ``oracle`` — the Nadaraya-Watson window and estimate in torch;
- ``controllers.lbmpc`` / ``controllers.sqp_fused`` — the Gauss-Newton SQP;
- ``controllers.nmpc`` — the NMPC (tracking and regulation) on the SQP with
  nonlinear constraints;
- ``controllers.tracking_sandbox`` — the double-integrator tracking MPC of
  the reference's didactic subtree (online terminal sets, nominal and tube);
- ``ops`` — the twelve hand-written CUDA kernels (``csrc/``: the GN phase
  K1/K1w, the Mehrotra QP with a Hessian per lane K2/K2w, the two in one
  launch K3/K3w, the shared-H QP K4, the batched Cholesky K5a/b/c and its
  slab-blocked form K6a/b) with their plain PyTorch versions, and the
  per-problem IPM and the stage-wise Riccati solvers in plain torch;
- ``runtime`` — the batched closed loop, the scenario and fleet builders,
  ``checkpoint`` (npz snapshots in the reference's format, resume) and
  ``profiling`` (stage timers, the solve-time protocol, torch.profiler
  traces);
- ``analysis`` — solve-time statistics, step-response metrics, comparison
  tables and figures (matplotlib, imported only to draw), and the roofline
  in H100 units;
- ``interop`` — carrying the reference package's objects across.

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
