"""Request statuses of GNN serving, as ``repro.runtime.scheduler`` names
them: every submitted request ends in exactly one of these. The
continuous-batching scheduler itself is not ported yet."""
from __future__ import annotations

SERVED_PACKED = "served_packed"
SERVED_PARTITIONED = "served_partitioned"
SERVED_FALLBACK = "served_fallback"
REJECTED_QUEUE = "rejected_queue_full"
REJECTED_OVERSIZE = "rejected_oversize"
REJECTED_INVALID = "rejected_invalid"
FAILED = "failed"
