"""The benchmark harness of granne_tpu_torch: one cell run once.

Everything that belongs to one configuration, one cell or one per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``cells/<workload>.json``, ``metrics/<metric>.py``.
A configuration names its system (``harness/systems/<system>.py``) and a cell
its kind of traffic (``harness/traffic/<kind>.py``).  This package imports
torch and numpy; only the system modules import granne_tpu_torch, and
nothing here imports JAX or the JAX package.
"""
