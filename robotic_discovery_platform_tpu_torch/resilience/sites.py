"""Central registry of fault-injection site names.

One constant per ``faults.inject(...)`` site, plus the per-instance
patterns (``serving.chip.<i>.dispatch``) as builder functions paired
with a wildcard the ``RDP_FAULTS`` grammar already understands. This is
the vocabulary chaos legs in CI arm and statecheck's SC004 lints
against: a string-literal site passed to ``inject()`` anywhere in the
package that is absent here is a fault point no chaos test can ever
have armed. Import the constant, never retype the string.

Zero imports on purpose: resilience sits below everything, including
the platform's own logging.
"""

from __future__ import annotations

# -- client / tracking -------------------------------------------------------

#: the client's frame-streaming loop
CLIENT_STREAM = "client.stream"
#: every tracking/registry REST round-trip
TRACKING_REST_REQUEST = "tracking.rest.request"

# -- serving -----------------------------------------------------------------

#: registry model-version resolution at startup / hot-reload poll
SERVING_RESOLVE = "serving.resolve"
#: the per-frame analyze path in the servicer
SERVING_ANALYZE = "serving.analyze"
#: the batching collector loop (window close -> dispatch handoff)
SERVING_BATCH_COLLECT = "serving.batch.collect"
#: the batch dispatch itself (device launch)
SERVING_BATCH_DISPATCH = "serving.batch.dispatch"
#: the completer's D2H readback of a finished batch
SERVING_BATCH_COMPLETE = "serving.batch.complete"
#: the decode worker pool's per-frame decode
SERVING_INGEST_DECODE = "serving.ingest.decode"
#: the ingest pipeline loop
SERVING_INGEST_LOOP = "serving.ingest.loop"
#: the encode worker pool's per-frame response encode
SERVING_EGRESS_ENCODE = "serving.egress.encode"
#: the egress encode-pool worker loop
SERVING_EGRESS_LOOP = "serving.egress.loop"


def chip_dispatch(chip: int) -> str:
    """The per-chip dispatch site: quarantine chaos arms one ring slot."""
    return f"serving.chip.{chip}.dispatch"


def model_dispatch(model: str) -> str:
    """The per-zoo-model dispatch site: cross-model isolation chaos."""
    return f"serving.model.{model}.dispatch"


#: wildcard spellings of the per-instance sites, as the RDP_FAULTS
#: grammar matches them (site families, e.g. "serving.chip.*.dispatch")
CHIP_DISPATCH_PATTERN = "serving.chip.*.dispatch"
MODEL_DISPATCH_PATTERN = "serving.model.*.dispatch"

#: every fixed site above (patterns excluded: they are families, not
#: literal sites)
ALL_SITES = (
    CLIENT_STREAM,
    TRACKING_REST_REQUEST,
    SERVING_RESOLVE,
    SERVING_ANALYZE,
    SERVING_BATCH_COLLECT,
    SERVING_BATCH_DISPATCH,
    SERVING_BATCH_COMPLETE,
    SERVING_INGEST_DECODE,
    SERVING_INGEST_LOOP,
    SERVING_EGRESS_ENCODE,
    SERVING_EGRESS_LOOP,
)

SITE_PATTERNS = (
    CHIP_DISPATCH_PATTERN,
    MODEL_DISPATCH_PATTERN,
)
