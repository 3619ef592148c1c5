"""Layer 2, input transfer: the device's idle time a batch of the traced
window while the host was inside the port's ``gnn.to_device`` span
(``packed_to_device``: the pageable copies' staging and waits), in ms.

Idle time is the gaps between the union of the device operations. A gap
counts for the time it overlaps the union of the span's host intervals,
so a gap that straddles a span's edge counts only in part. ``None``
when the trace holds no device operation or none of the spans (a
program without them)."""

SPANS = ("gnn.to_device",)


def intervals(trace, names) -> list:
    """The union of the host intervals of the events named one of
    ``names``, in order, as [start_ns, end_ns] pairs."""
    merged = []
    for t0, t1 in sorted((t0, t1) for name, t0, t1 in trace.host
                         if name in names):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return merged


def overlap_ns(a: list, b: list) -> int:
    """The length of the intersection of two ordered, disjoint interval
    lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms(trace, names):
    """Device-idle ms a batch overlapped with the spans ``names``."""
    if trace is None or not trace.batches or not trace.device:
        return None
    spans = intervals(trace, names)
    if not spans:
        return None
    busy = trace.busy_intervals()
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    return overlap_ns(gaps, spans) / 1e6 / trace.batches


def read(ctx):
    return idle_ms(ctx.trace, SPANS)
