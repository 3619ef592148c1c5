"""Device resolution and the fp32 numerics the port runs with."""
from __future__ import annotations

import contextlib
import contextvars

import torch

_FAKE_CARD: contextvars.ContextVar = contextvars.ContextVar("fake_card",
                                                           default=None)


@contextlib.contextmanager
def fake_card(device: torch.device):
    """The dry run's card (``launch.dryrun``): inside the block, and only
    under an active ``FakeTensorMode``, ``resolve_device("cuda")`` names
    ``device``, on which the fake tensors of the traced program lie. The
    block holds no card: whatever runs in it allocates nothing and
    launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    if not any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack()):
        raise RuntimeError("fake_card needs an active FakeTensorMode")
    token = _FAKE_CARD.set(torch.device(device))
    try:
        yield
    finally:
        _FAKE_CARD.reset(token)


def set_fp32_numerics() -> None:
    """Pin float32 matmuls and convolutions to full fp32. The JAX
    reference runs every matmul in full fp32; TF32 keeps about three
    decimal digits, which would put the port outside the reference's
    1e-4 parity tolerance at the paper's widths."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def l2_cache_bytes(device: torch.device) -> int | None:
    """The L2 cache size of a CUDA device; None for the CPU."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).L2_cache_size)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default) needs
    a card and raises without one — the port never carries on quietly
    on the CPU; ``"cpu"`` runs the plain PyTorch versions of the
    kernels."""
    dev = torch.device(device)
    fake = _FAKE_CARD.get()
    if fake is not None and dev.type in ("cuda", fake.type):
        return fake
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        set_fp32_numerics()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
