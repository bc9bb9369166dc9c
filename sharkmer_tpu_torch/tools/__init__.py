"""Offline tools: synthetic read generation (``synth``), the offline
benchmark grid (``run_grid``, with ``validate``'s runner, result and
report modules), the throughput benchmark (``bench``), and a profiler
trace of one CLI run on the card (``trace_spcr``)."""
