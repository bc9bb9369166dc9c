"""In silico PCR (sPCR): primer-seeded de Bruijn graph assembly.

Host-side graph control flow + device-side batched table lookups.
Reference: upstream sharkmer src/pcr/.
"""

from .params import (  # noqa: F401
    DEFAULT_DEDUP_EDIT_THRESHOLD,
    DEFAULT_HIGH_COVERAGE_RATIO,
    DEFAULT_MAX_DFS_STATES,
    DEFAULT_MAX_NODE_VISITS,
    DEFAULT_MAX_NUM_PRIMER_KMERS,
    DEFAULT_MAX_PATHS_PER_PAIR,
    DEFAULT_TIP_COVERAGE_FRACTION,
    PCRParams,
    validate_pcr_params,
)
from .graph import compute_node_budget  # noqa: F401
from .spcr import PcrOutcome, do_pcr  # noqa: F401
