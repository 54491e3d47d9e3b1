"""Plotting layer of the PyTorch port (mirrors optimal_control_paradiag_tpu/viz)."""
