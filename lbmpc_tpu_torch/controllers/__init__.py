"""Controllers: condensed QP builders, the LBMPC residual and the fused SQP."""
