"""The port's benchmark: ``BENCHMARK.json`` at the root of the repository
names its cells; ``run.py`` runs one (see ``harness.py``)."""
