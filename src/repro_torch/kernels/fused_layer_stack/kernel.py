"""Launch of the hand-written CUDA resident layer-stack kernel
(``csrc/fused_layer_stack.cu``), the port of the Pallas TPU kernel
``repro/kernels/fused_gather_aggregate/residency.py``,
``fused_layer_stack_pallas``. The source carries the design note: one
cooperative launch runs every layer, a grid barrier between layers, the
table ping-ponging between two buffers; each block owns a balanced range
of rows, stages each layer's real-width weights into shared memory once,
folds a chunk's in-edges into shared memory in CSR order and multiplies
the chunk by the weights with SIMT fp32 in 8 x 4 register tiles.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_layer_stack.ref import resolve_widths
from repro_torch.nn.layers import ACTIVATIONS

KIND_CODES = {"gcn": 0, "sage": 1}
# enum Act in csrc/fused_layer_stack.cu
ACT_CODES = {name: i for i, name in enumerate(ACTIVATIONS)}
MAX_FMAX = 512          # kMaxF: a 16-row chunk beside the weight ring
MAX_LAYERS = 32         # kMaxLayers: the widths ride in the launch params

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
             _P, _I, _I, _I, _P, _P, _P, _P]


def _check_dense(name: str, t: torch.Tensor, shape: tuple,
                 device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32 or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor of "
                         f"shape {shape}, got {t.dtype} of shape "
                         f"{tuple(t.shape)}")


@_build.launcher(lambda x, *_, **__: torch.empty_like(x))
def fused_layer_stack_cuda(x: torch.Tensor, src: torch.Tensor,
                           scale: torch.Tensor, perm: torch.Tensor,
                           offsets: torch.Tensor, self_vec: torch.Tensor,
                           node_mask: torch.Tensor, w_a: torch.Tensor,
                           w_n: torch.Tensor, w_skip: torch.Tensor,
                           b: torch.Tensor, qp: torch.Tensor, *, kind: str,
                           activation: str = "relu", has_skip: bool = True,
                           widths=None) -> torch.Tensor:
    """x: (N, F) float32 table, F a multiple of 32 up to ``MAX_FMAX``;
    src/scale: (E,) int32 source ids / float32 edge scales; perm/offsets:
    the destination CSR over the N rows (``core.aggregations.gather_csr``,
    which leaves out every edge with an out-of-range id); self_vec /
    node_mask: (N,) float32; w_a/w_n/w_skip: (K, F, F), b: (K, F), qp:
    (K, 4) float32 rows [mode, s, lo, hi]; x and the weights 16-byte
    aligned. ``widths``: the K layers' real (in, out) widths (default
    (F, F)); the kernel reads only the real blocks of the weights and
    bias and writes the padding columns as ``act(0) * mask``. Returns the (N, F) float32 table after the K layers. One cooperative
    launch on the current stream; a launch the card refuses raises."""
    if kind not in KIND_CODES:
        raise ValueError(f"kind {kind!r} not in {tuple(KIND_CODES)}")
    if activation not in ACT_CODES:
        raise ValueError(f"activation {activation!r} not in "
                         f"{tuple(ACT_CODES)}")
    _build.check_table("x", x)
    dev = x.device
    n, f = x.shape
    k = w_n.shape[0] if w_n.dim() == 3 else 0
    if x.dtype != torch.float32 or n < 1 or f % 32 or not 0 < f <= MAX_FMAX \
            or not 1 <= k <= MAX_LAYERS:
        raise ValueError(f"x must be a float32 (N >= 1, F) table with F a "
                         f"multiple of 32 up to {MAX_FMAX} and 1 to "
                         f"{MAX_LAYERS} layers; got {x.dtype} "
                         f"{tuple(x.shape)}, K={k}")
    dims = resolve_widths(widths, f, k)
    e = src.numel()
    _build.check_vector("src", src, torch.int32, dev)
    _build.check_vector("scale", scale, torch.float32, dev, e)
    _build.check_vector("perm", perm, torch.int32, dev)
    _build.check_vector("offsets", offsets, torch.int32, dev, n + 1)
    if perm.numel() > e:
        raise ValueError(f"CSR of {perm.numel()} ids does not fit {e} "
                         "edges")
    for name, t, shape in (("self_vec", self_vec, (n,)),
                           ("node_mask", node_mask, (n,)),
                           ("w_a", w_a, (k, f, f)), ("w_n", w_n, (k, f, f)),
                           ("w_skip", w_skip, (k, f, f)), ("b", b, (k, f)),
                           ("qp", qp, (k, 4))):
        _check_dense(name, t, shape, dev)
    for name, t in (("x", x), ("w_a", w_a), ("w_n", w_n),
                    ("w_skip", w_skip)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned: the kernel "
                             "stages it by 16-byte copies")
    out = torch.empty_like(x)
    scratch = torch.empty_like(x) if k > 1 else None
    pairs = (ctypes.c_int32 * (2 * k))(*(v for p in dims for v in p))
    fn = _build.function("repro_fused_layer_stack", _ARGTYPES)
    P = _build.pointer
    with torch.cuda.device(dev):
        status = fn(P(x), n, f, k, P(src), P(scale), e, P(perm), P(offsets),
                    P(self_vec), P(node_mask), P(w_a), P(w_n), P(w_skip),
                    P(b), P(qp), KIND_CODES[kind], ACT_CODES[activation],
                    int(has_skip), P(out), P(scratch),
                    ctypes.cast(pairs, ctypes.c_void_p),
                    _build.stream_pointer(dev))
    _build.check(status, "fused_layer_stack")
    return out
