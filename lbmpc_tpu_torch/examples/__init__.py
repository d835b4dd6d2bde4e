"""Runnable examples: `python -m lbmpc_tpu_torch.examples.<name>`."""
