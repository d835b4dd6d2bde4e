"""Plant / model library (reference layer L0: matlab/LBMPC/models/)."""

from lbmpc_tpu_torch.models.mgcm import (
    MGCM_EQ_X,
    MGCM_EQ_U,
    mgcm_ode,
    rk4_step,
    rk23_step,
    mgcm_dlti,
    nominal_step,
)
from lbmpc_tpu_torch.models.linear import DLTIModel, double_integrator
