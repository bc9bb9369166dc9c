"""The port's counterpart of ``scripts/sharkmer_validate``: ``runner``
drives ``python -m sharkmer_tpu_torch`` and parses its outputs into a
run record; ``results`` and ``report`` (copies of the originals, held
to them by the drift test) write the result YAML and the markdown
report."""
