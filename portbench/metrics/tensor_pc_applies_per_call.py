"""Preconditioner applies per call of the 2D consistent mass's tensor
GMRES: the port's ``pc.tensor_mass.applies`` count over its
``solve.tensor_gmres`` count (``utils.timing.counters``, which count
whether or not a profiler records). In lock-step that is the slowest
lane's GMRES steps plus the left preconditioner's first apply (one more a
restart). The counts run from the process's start: the warm-up pass, the
profiler's warm-up pass and the traced pass solve the same pool, so the
ratio is the traced calls'. None outside a traced 2D consistent-mass wave
cell, and where the port keeps no such counts."""


def read(run):
    pc = run.cell.config["problem_config"]
    if run.trace is None or run.cell.config["problem"] != "wave" or pc["dim"] != 2 or pc["mass"] != "consistent":
        return None
    from optimal_control_paradiag_torch.utils import timing

    counts = getattr(timing, "counters", None)
    if not counts or not counts.get("solve.tensor_gmres") or not counts.get("pc.tensor_mass.applies"):
        return None
    return counts["pc.tensor_mass.applies"] / counts["solve.tensor_gmres"]
