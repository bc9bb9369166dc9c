"""Offline tools: synthetic read generation (``synth``) and a profiler
trace of one CLI run on the card (``trace_spcr``)."""
