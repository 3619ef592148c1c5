"""Layer 4, row 2 (the CSR segment reduction): the least time of the
model's segment reductions, the pooling set and PNA's towers, over the
traced window's batches (``work.model.segment_reductions``) over the
device time of the launches of ``KERNELS``, in %."""
from bench.peaks import least_seconds
from bench.work import model as work

KERNELS = (r"\bsegment_aggregate_kernel\b",)


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    spent = tr.seconds(kinds=("kernel",), match=KERNELS)
    least = sum(least_seconds(*w) for p in ctx.traced
                for w in work.segment_reductions(ctx.model,
                                                 *ctx.batch_counts[p]))
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
