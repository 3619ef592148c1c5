"""Layer 1, the served batch: the host calls that enqueue device work
(``LAUNCHES``: kernel launches, async copies and memsets, a graph's
replay) started inside the port's ``gnn.to_device`` or ``gnn.forward``
span, a batch of the traced window. ``None`` when the trace holds no
device operation or none of the spans."""
import bisect
import re

from bench.cell import metric_reader

SPANS = ("gnn.to_device", "gnn.forward")
LAUNCHES = re.compile(r"^(?:cudaLaunchKernel|cuLaunchKernel"
                      r"|cudaLaunchCooperativeKernel|cudaMemcpyAsync"
                      r"|cudaMemsetAsync|cudaGraphLaunch)")


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.batches or not tr.device:
        return None
    spans = metric_reader("idle_h2d_ms.serve").intervals(tr, SPANS)
    if not spans:
        return None
    starts = [s[0] for s in spans]
    n = 0
    for name, t0, _ in tr.host:
        if LAUNCHES.match(name):
            k = bisect.bisect_right(starts, t0) - 1
            if k >= 0 and t0 < spans[k][1]:
                n += 1
    return n / tr.batches
