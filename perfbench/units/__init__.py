"""The units of work a traffic mix repeats, each through the port's own
entry points.

A traffic file names its unit (``"unit": "count"``); the unit's code is
``perfbench/units/<unit>.py``, found by that name as a metric's reader
is: a class ``Unit`` built on ``Unit`` here, whose ``run()`` does one
unit from a fresh engine and returns what the check needs (``Done``), and
whose ``checks()`` may add numbers of its own outputs. A new kind of
work is a new file here and a new traffic file; no file changes.

Spans are the benchmark's, around its calls into each layer: host-clock
walls, and in a traced run profiler ranges named ``perfbench.<span>``.
"""

from __future__ import annotations

import importlib
import re
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass

import torch

from ..devtrace import SPAN_PREFIX

HISTO_MAX = 10000  # the CLI's --histo-max default
UNIT_NAME = re.compile(r"[a-z_][a-z0-9_]*")


class Spans:
    """Host-clock walls by span name, and profiler ranges when traced."""

    def __init__(self):
        self.walls: dict[str, list[float]] = defaultdict(list)
        self.traced = False

    @contextmanager
    def __call__(self, name: str):
        start = time.perf_counter()
        if self.traced:
            with torch.profiler.record_function(SPAN_PREFIX + name):
                yield
        else:
            yield
        self.walls[name].append(time.perf_counter() - start)

    def clear(self) -> None:
        self.walls.clear()


@dataclass
class Done:
    """What a unit leaves for the check after the window."""
    engine: object  # the unit's engine; its table is judged for the last
    spectra: list | None  # consolidate()'s snapshots
    events: int  # k-mer events the unit counted
    outdir: str | None = None  # files the unit wrote
    phases: dict | None = None  # utils.phases after the unit's sPCR


class Unit:
    """One unit of work over the sample; ``run`` is the unit's own."""

    def __init__(self, cfg: dict, traffic: dict, sample, device,
                 spans: Spans, workdir: str):
        self.cfg, self.traffic, self.sample = cfg, traffic, sample
        self.device = torch.device(device)
        self.spans, self.workdir = spans, workdir
        self.n = 0

    def run(self) -> Done:
        raise NotImplementedError

    def checks(self, kept: list[Done]) -> tuple[dict, list[bool]]:
        """Numbers of the units' own outputs, each ``{"value", "limit"}``,
        and which of ``kept`` got any of them wrong."""
        return {}, [False] * len(kept)

    def sync(self) -> None:
        from sharkmer_tpu_torch.device import synchronize

        synchronize(self.device)

    def ingest(self, engine) -> None:
        """Every batch through ``ingest_code_batch``, the entry the native
        loader's consumer calls (``main._ingest_all``), then a
        synchronise."""
        for codes, lens in self.sample.batches:
            engine.ingest_code_batch(codes, lens)
        self.sync()


def make(cfg: dict, traffic: dict, sample, device, spans: Spans,
         workdir: str) -> Unit:
    """The traffic's unit: ``Unit`` of ``perfbench/units/<unit>.py``."""
    name = traffic["unit"]
    if not UNIT_NAME.fullmatch(name):
        raise ValueError(f"no unit {name!r}")
    module = importlib.import_module(f"{__name__}.{name}")
    return module.Unit(cfg, traffic, sample, device, spans, workdir)
