"""Per-layer metrics, one reader a file, found by the metric's name in
``BENCHMARK.json``, read in the run with ``--trace 1``; the functions
that count a kernel's bytes live here (``bytes.py``)."""
