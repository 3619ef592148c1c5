"""Layer 2, input transfer (``packed_to_device``): device time in host ->
device copies, per batch of the traced window, in ms."""

COPIES = (r"HtoD",)


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.batches:
        return None
    s = tr.seconds(kinds=("memcpy",), match=COPIES)
    return 1e3 * s / tr.batches if s > 0 else None
