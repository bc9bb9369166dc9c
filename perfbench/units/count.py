"""A count pass: a fresh ``CountingEngine`` takes every batch of the
sample through ``ingest_code_batch``, then ``consolidate()`` gives the
spectra; each stage ends in a synchronise, at the boundaries of the
CLI's stage walls. The traffic gives ``n_chunks``."""

from __future__ import annotations

from . import HISTO_MAX, Done
from . import Unit as Base


class Unit(Base):
    def run(self) -> Done:
        from sharkmer_tpu_torch.engine import CountingEngine

        self.n += 1
        engine = CountingEngine(
            k=self.cfg["k"], device=self.device,
            n_chunks=self.traffic["n_chunks"], histo_max=HISTO_MAX,
            initial_capacity=self.cfg["initial_capacity"],
            backend=self.cfg["backend"])
        with self.spans("ingest"):
            self.ingest(engine)
        with self.spans("consolidate"):
            spectra = engine.consolidate()
            self.sync()
        return Done(engine, spectra, self.sample.n_events)
