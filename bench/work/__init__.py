"""What the model's operations need, counted from their semantic inputs
(real nodes, valid edges, widths), whatever implements them: the
model's FLOPs (``model.flops``) and the least bytes and operations of
its neighbour sums and segment reductions. The conv of a configuration
is ``work/conv_<gnn_conv>.py``."""
