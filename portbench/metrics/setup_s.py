"""Process start to the first timed call: importing, the card's context,
loading (or, in a fresh checkout, compiling) the kernels, the problem, the
pool of inputs and one warm-up call on each."""


def read(run):
    return run.setup_s
