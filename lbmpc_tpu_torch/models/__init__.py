"""Plant / model library (reference layer L0: matlab/LBMPC/models/)."""
