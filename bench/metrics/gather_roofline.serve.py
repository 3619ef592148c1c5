"""Layer 4, row 1 (the CSR neighbour gather): the least time of the
model's neighbour sums over the traced window's batches (real nodes,
valid edges and the layers' widths, ``work.model.neighbour_sums``)
over the device time of the launches of ``KERNELS``, in %."""
from bench.peaks import least_seconds
from bench.work import model as work

KERNELS = (r"\bfused_gather_aggregate_kernel\b",)


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    spent = tr.seconds(kinds=("kernel",), match=KERNELS)
    least = sum(least_seconds(*w) for p in ctx.traced
                for w in work.neighbour_sums(ctx.model,
                                             *ctx.batch_counts[p]))
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
