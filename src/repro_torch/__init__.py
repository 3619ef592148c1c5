"""PyTorch/CUDA port of the GNNBuilder packed-inference path.

Mirrors the layout of the JAX package ``repro`` (``configs``, ``data``,
``nn``, ``kernels``, ``core``, ``runtime``, ``launch``) so each module's
counterpart is easy to find. It imports torch and numpy only; the CUDA
kernels under ``csrc/`` are compiled at their first launch, never at
import, so the package imports on a host with no GPU and no compiler.

Entry points take a ``device`` argument that defaults to ``"cuda"`` and
raise when no card is present unless the caller asks for ``"cpu"``
(``repro_torch.device.resolve_device``).
"""
