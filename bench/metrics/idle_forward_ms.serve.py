"""Layer 1, the served batch: the device's idle time a batch of the
traced window while the host was inside the port's ``gnn.forward`` span
(``apply_packed``: Python, operator dispatch and launch calls between
kernels), in ms, by time overlap as ``idle_h2d_ms.serve`` counts it."""
from bench.cell import metric_reader

SPANS = ("gnn.forward",)


def read(ctx):
    return metric_reader("idle_h2d_ms.serve").idle_ms(ctx.trace, SPANS)
