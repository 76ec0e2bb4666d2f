"""Per-layer metrics, one reader a file: ``<metric>.py`` defines
``read(rec)``, which takes a traced stretch's ``bench.trace.Record`` and
returns the metric's value, or None where the stretch holds nothing for it
to read.  ``bench/run.py`` finds each by the name ``BENCHMARK.json`` gives
it."""
