"""Layer 1, the served batch: the host's time from the call into the
port with the batch's host arrays in hand until the call returns, before
the copy of the outputs to the host waits for the device (the launch
overhead, the pageable input copies included). Mean over the batches of
the untraced window, in ms."""


def read(ctx):
    e = ctx.window["enqueue_s"]
    return 1e3 * sum(e) / len(e) if e else None
