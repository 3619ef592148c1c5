"""Named host spans on the served path, recorded only while a torch
profiler records.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
profiler (``torch.profiler.profile`` or the autograd profiler) is
recording, and one shared null context otherwise: one flag read a call,
no string built and no ``RecordFunction`` made. There is no switch and
no exporter: run anything under ``torch.profiler.profile`` and the
spans appear among its host events. They are Kineto host ranges, on the
clock of the device operations CUPTI records beside them, so a trace
can lay them over the device's idle gaps. A span adds no device work
and no synchronisation.

The spans of ``core.gnn_model`` and the benchmark metric that reads
each (``bench/metrics/<metric>.py``, which names its spans literally):

===================  ===============================  ======================
span                 where                            metric
===================  ===============================  ======================
``gnn.to_device``    ``packed_to_device``: the        ``idle_h2d_ms.serve``,
                     host -> device copies            ``launches.serve``
``gnn.forward``      ``apply_packed``'s body          ``idle_forward_ms.serve``,
                                                      ``launches.serve``
``gnn.inputs``       ``_edge_inputs``: degrees, GCN   inside ``gnn.forward``
                     scales, the CSR sorts
``gnn.conv<i>``      layer ``i`` of ``_backbone``:    inside ``gnn.forward``
                     conv, skip, activation, mask
``gnn.pool``         ``_packed_tail``'s pooling       inside ``gnn.forward``
``gnn.head``         ``_head``: the MLP head          inside ``gnn.forward``
===================  ===============================  ======================

The padded oracle (``apply``, ``apply_batch``), the resident and the
partitioned programs share the helpers and so the inner spans.
"""
from __future__ import annotations

import contextlib
import functools

from torch.autograd import profiler as _profiler

TO_DEVICE = "gnn.to_device"
FORWARD = "gnn.forward"
INPUTS = "gnn.inputs"
POOL = "gnn.pool"
HEAD = "gnn.head"

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records, else the shared null context."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF


@functools.lru_cache(maxsize=None)
def conv_spans(num_layers: int) -> tuple:
    """The names of layers 0 .. ``num_layers`` - 1, built once a depth."""
    return tuple(f"gnn.conv{i}" for i in range(num_layers))
