"""The device trace of a window, from ``torch.profiler`` (CUPTI), and what
the per-layer metrics read from it.

``record`` runs a loop under the profiler with the host's and the
device's activities and keeps the raw events: every device operation
(kernel, copy, memset) with its interval, and every host event (PyTorch
operators, CUDA runtime calls) with its interval. Nothing is exported
to disk.
"""
from __future__ import annotations

import dataclasses
import re
import time

DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
                "gpu_memset": "memset"}


@dataclasses.dataclass
class DeviceTrace:
    """The traced window: ``device`` holds (name, kind, start_ns, end_ns)
    of each device operation, ``host`` (name, start_ns, end_ns) of each
    host event; ``window_s`` is the loop's length on the host clock and
    ``batches`` the batches it served."""
    device: list
    host: list
    window_s: float
    batches: int

    def seconds(self, kinds=("kernel", "memcpy", "memset"),
                match=None, exclude=None) -> float:
        """Device seconds of the operations of ``kinds`` whose name
        matches one of the ``match`` patterns (any, when None) and none
        of the ``exclude`` patterns."""
        inc = _compile(match)
        exc = _compile(exclude)
        total = 0
        for name, kind, t0, t1 in self.device:
            if kind not in kinds:
                continue
            if inc is not None and not inc.search(name):
                continue
            if exc is not None and exc.search(name):
                continue
            total += t1 - t0
        return total / 1e9

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, in order."""
        spans = sorted((t0, t1) for _, _, t0, t1 in self.device)
        merged = []
        for t0, t1 in spans:
            if merged and t0 <= merged[-1][1]:
                if t1 > merged[-1][1]:
                    merged[-1][1] = t1
            else:
                merged.append([t0, t1])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(t1 - t0 for t0, t1 in self.busy_intervals()) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, summed by name, and
        the idle time between device operations summed by what the host
        was doing when each gap began (the innermost host event open at
        that moment), each list the ``top`` largest, in seconds."""
        ops = {}
        for name, _, t0, t1 in self.device:
            ops[name] = ops.get(name, 0) + (t1 - t0)
        busy = self.busy_intervals()
        gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
        host = sorted(self.host, key=lambda e: e[1])
        idle, stack, k = {}, [], 0
        for g0, g1 in gaps:
            # a sweep over the host events in start order keeps the open
            # ones on a stack, the innermost on top
            while k < len(host) and host[k][1] <= g0:
                while stack and stack[-1][2] <= host[k][1]:
                    stack.pop()
                stack.append(host[k])
                k += 1
            while stack and stack[-1][2] <= g0:
                stack.pop()
            name = stack[-1][0] if stack else "python"
            idle[name] = idle.get(name, 0) + (g1 - g0)

        def top_of(d):
            return [[_short(k), v / 1e9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": top_of(ops), "idle_gaps": top_of(idle)}


def _compile(patterns):
    if not patterns:
        return None
    return re.compile("|".join(f"(?:{p})" for p in patterns))


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def _device_kind(e) -> str | None:
    """kernel, memcpy or memset for a device operation, None for another
    device event (a user range mirrored on the device). Older PyTorch
    builds give no activity type: there the name tells."""
    if hasattr(e, "activity_type"):
        return DEVICE_KINDS.get(e.activity_type())
    if getattr(e, "is_user_annotation", lambda: False)():
        return None
    name = e.name()
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def record(loop) -> DeviceTrace:
    """Run ``loop()`` (which returns the number of batches it served)
    under the profiler. The host clock spans the loop alone; the
    profiler is started before it and stopped after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batches = loop()
        window_s = time.perf_counter() - t0
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            kind = _device_kind(e)
            if kind is not None:
                device.append((e.name(), kind, e.start_ns(), e.end_ns()))
        elif e.device_type() == DeviceType.CPU and e.end_ns() > e.start_ns():
            host.append((e.name(), e.start_ns(), e.end_ns()))
    return DeviceTrace(device, host, window_s, batches)
