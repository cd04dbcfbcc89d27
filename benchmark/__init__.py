"""The port's benchmark: ``python3 -m benchmark.run --workload <cell> ...`` (see ``run.py``)."""
