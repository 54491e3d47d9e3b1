"""krylov layer of the PyTorch port (mirrors optimal_control_paradiag_tpu/krylov):
restarted GMRES and batched COCG."""

from optimal_control_paradiag_torch.krylov.cocg import cocg
from optimal_control_paradiag_torch.krylov.gmres import GmresResult, clamp_restart, gmres

__all__ = ["GmresResult", "clamp_restart", "cocg", "gmres"]
