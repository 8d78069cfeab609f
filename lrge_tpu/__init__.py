"""lrge_tpu — accelerator-native long-read overlap engine and genome-size estimator.

A from-scratch reimplementation of the capabilities of LRGE
(`mbhall88/lrge`): estimate genome size from long reads by counting
read-to-read overlaps, where the overlap engine (minimizer sketching,
indexing, colinear chaining) runs as JAX/XLA programs on a GPU
instead of wrapping minimap2.

Public API mirrors the reference library surface (`liblrge/src/lib.rs`):

    from lrge_tpu import twoset, ava, Platform, Estimate
    est = (twoset.Builder()
           .target_num_reads(10_000)
           .query_num_reads(5_000)
           .seed(42)
           .build("reads.fq")
           .estimate(finite=True))
"""

from . import errors
from .estimate import (
    Estimate,
    EstimateResult,
    LOWER_QUANTILE,
    UPPER_QUANTILE,
    per_read_estimate,
)
from .platform import AVA_ONT, AVA_PB, OverlapParams, Platform
from .strategy import (
    AvaBuilder,
    AvaStrategy,
    DEFAULT_AVA_NUM_READS,
    DEFAULT_QUERY_NUM_READS,
    DEFAULT_TARGET_NUM_READS,
    TwoSetBuilder,
    TwoSetStrategy,
)

__version__ = "0.5.0"

# namespace mirrors of liblrge::twoset / liblrge::ava
from . import ava, twoset  # noqa: E402

__all__ = [
    "errors",
    "Estimate",
    "EstimateResult",
    "LOWER_QUANTILE",
    "UPPER_QUANTILE",
    "per_read_estimate",
    "Platform",
    "OverlapParams",
    "AVA_ONT",
    "AVA_PB",
    "TwoSetStrategy",
    "TwoSetBuilder",
    "AvaStrategy",
    "AvaBuilder",
    "twoset",
    "ava",
    "DEFAULT_TARGET_NUM_READS",
    "DEFAULT_QUERY_NUM_READS",
    "DEFAULT_AVA_NUM_READS",
]
