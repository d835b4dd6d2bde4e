"""The analysis layer: solve-time statistics (``solve_stats``), step-response
metrics on tensors (``metrics``), comparison tables and overlay figures
(``compare``), the reference's plots (``plots``; matplotlib, imported only
when a figure is drawn) and the roofline in H100 units (``roofline``)."""
