"""Retained read records for Pass 2 threading (io.rs:37-52)."""

from __future__ import annotations

import enum
from dataclasses import dataclass


class Mate(enum.Enum):
    UNPAIRED = 0
    R1 = 1
    R2 = 2


@dataclass
class ReadRecord:
    sequence: str
    index: int
    mate: Mate = Mate.UNPAIRED
