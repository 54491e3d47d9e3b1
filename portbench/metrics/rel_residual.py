"""||A x - b|| / ||b|| in float64 by the benchmark's reference, of the
window's last answer to member 0 of the pool (the configuration's own
manufactured data, the same in every run; the seeded members are judged
for ``correct`` only)."""


def read(run):
    rel = [r for r, f in zip(run.judged["rel_residual"], run.judged["fixed"]) if f]
    return max(rel) if rel else None
