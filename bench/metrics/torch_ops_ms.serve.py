"""Layer 3, the eager PyTorch operations around the port's kernels:
device time per batch of the traced window in kernels and memsets that
are neither a copy nor one of the port's own kernels (sorts, the
degrees' ``index_add_``, products, concatenations, elementwise), in ms.
``PORT_KERNELS`` names every kernel of the port's ``csrc/``; a kernel
the port adds later under another name counts here."""

PORT_KERNELS = tuple(rf"\b{k}\b" for k in (
    "attention_simt_kernel", "attention_wgmma_kernel", "count_rows",
    "delta_kernel", "dkdv_kernel", "dkdv_wgmma_kernel", "dq_kernel",
    "dq_wgmma_kernel", "fused_gather_aggregate_kernel",
    "fused_gather_onehot_fold", "fused_layer_stack_kernel",
    "gather_minmax_dx_kernel", "gather_scale_backward_generic_kernel",
    "gather_scale_backward_kernel", "gather_tie_weights_kernel",
    "gnn_aggregate_kernel", "matmul_simt_kernel", "matmul_wgmma_kernel",
    "scan_tiles", "scatter_rows", "scatter_tiles",
    "segment_aggregate_backward_kernel", "segment_aggregate_kernel",
    "segment_aggregate_onehot_fold", "segment_softmax_backward_kernel",
    "segment_softmax_kernel"))


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.batches:
        return None
    s = tr.seconds(kinds=("kernel", "memset"), exclude=PORT_KERNELS)
    return 1e3 * s / tr.batches if s > 0 else None
