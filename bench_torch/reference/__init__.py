"""The benchmark's plain reference: a copy of the port's plain PyTorch
path tracer (its scenes, integrator, ops and blit) that imports nothing
of ``tpurt_torch`` and takes nothing the program made, so that a change
to the port's own plain version cannot move the comparison that decides
``correct`` (``bench_torch/check.py``)."""
