"""The benchmark's plain reference of the two all-at-once KKT systems.

Written from the equations in plain PyTorch and NumPy; it imports nothing of
the port or of the JAX package and takes nothing the program made: it works
out the operator and the right-hand side again from the configuration and
the data the benchmark generated. ``model.py`` holds the operator, the
right-hand side and the relative residual that judges an answer;
``solve.py`` a direct solve, run in a lower precision as the control of
``correct``.
"""
