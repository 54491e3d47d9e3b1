"""Solution output of the PyTorch port: npz archives and legacy-VTK series
(mirrors optimal_control_paradiag_tpu/io)."""

from optimal_control_paradiag_torch.io.writers import write_solution

__all__ = ["write_solution"]
