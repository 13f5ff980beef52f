"""End-to-end metrics, one reader a file, found by the metric's name in
``BENCHMARK.json``. Each is taken on the host's clock from the client's
side of the cluster (see ``ecbench/reading.py``)."""
