"""GMRES iterations per solve (``GmresResult.iterations``), the mean over
the traced calls' right-hand sides."""


def read(run):
    return sum(run.iterations) / len(run.iterations) if run.iterations else None
