"""Build, load and call the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. The
build runs at the first kernel launch, never at import, so the package
imports on hosts without a GPU or a CUDA toolkit. Each source compiles
in its own ``nvcc`` process, all started together, then one link.

The library's file name carries a hash of the sources, the headers and
the flags, so a stale build is never loaded: an edited source gets a new
library. Builds go to ``build/repro_torch/`` at the root of the checkout
(listed in ``.gitignore``).

The launch wrappers (``kernels/*/kernel.py``) share the argument checks,
pointer and stream helpers and the agg/dtype codes of the C interface
kept here.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _cost

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# register / shared-memory / spill report of every kernel, kept in the
# build log
PTXAS_VERBOSE = ("-Xptxas", "-v")

# codes of the C interface (enum Agg / enum Dtype in csrc/common.cuh)
AGG_CODES = {"sum": 0, "mean": 1, "min": 2, "max": 3, "var": 4, "std": 5}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the name of each storage type of a streamed table (the key of a
# wrapper's ``launches_by_dtype``), and the ones a backward kernel takes
# (a body each: the segment aggregation's messages, the gather's table)
STORAGE = {torch.float32: "fp32", torch.bfloat16: "bf16", torch.int8: "int8"}
GRAD_STORAGE = {torch.float32: "fp32", torch.bfloat16: "bf16"}
_INT_MAX = 2 ** 31 - 1

_lib: ctypes.CDLL | None = None
_functions: dict = {}
_lock = threading.Lock()


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of every source and header under csrc/ plus the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + PTXAS_VERBOSE).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(digest: str | None = None) -> Path:
    """The library built from the sources of ``digest`` (default: the
    sources as they are now)."""
    return BUILD_DIR / f"librepro_torch_{digest or source_hash()}.so"


def log_path(digest: str | None = None) -> Path:
    return library_path(digest).with_suffix(".log")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built on this host")
    return found


def build() -> Path:
    """Compile the library unless a build of these exact sources exists;
    returns its path. Raises RuntimeError with nvcc's output on a
    failed build."""
    digest = source_hash()
    lib = library_path(digest)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    tag = f"{digest}.{os.getpid()}"
    procs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [compiler, *NVCC_FLAGS, *PTXAS_VERBOSE, "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / f"{lib.name}.{tag}.tmp"
    link = subprocess.run(
        [compiler, *NVCC_FLAGS, "-shared", *(str(o) for _, o, _ in procs),
         "-o", str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    log_path(digest).write_text("\n".join(log))
    os.replace(tmp, lib)          # atomic: concurrent builds never clash
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def function(name: str, argtypes: list):
    """A C entry point of the library with its argument types declared
    (every pointer and the stream as ``ctypes.c_void_p``: an undeclared
    argument is passed as a 32-bit int and a pointer would be cut)."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        msg = library().repro_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")


def check_cuda(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")


def check_table(name: str, t: torch.Tensor) -> None:
    """A (rows, F) table the kernels stream: CUDA, 2-D, contiguous, of a
    storage type they take."""
    check_cuda(name, t)
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D tensor, got "
                         f"shape {tuple(t.shape)}")
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name} dtype {t.dtype} not in "
                         f"{tuple(DTYPE_CODES)}")
    if max(t.shape) > _INT_MAX:
        raise ValueError(f"{name} shape {tuple(t.shape)} exceeds int32")


def check_vector(name: str, t: torch.Tensor, dtype: torch.dtype,
                 device: torch.device, numel: int | None = None) -> None:
    """A 1-D contiguous id or scale stream on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor, "
                         f"got {t.dtype} of shape {tuple(t.shape)}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected "
                         f"{numel}")
    if t.numel() > _INT_MAX:
        raise ValueError(f"{name} has {t.numel()} elements, exceeds int32")


def check_tiles(node_block: int, edge_block: int) -> None:
    """The one-hot kernels' tile sizes: ints of at least 1 that fit the
    C interface."""
    for name, v in (("node_block", node_block), ("edge_block", edge_block)):
        if not isinstance(v, int) or isinstance(v, bool) \
                or not 1 <= v <= _INT_MAX:
            raise ValueError(f"{name} must be an int >= 1, got {v!r}")


def launcher(outputs):
    """Decorate a kernel's launch function (``kernels/*/kernel.py``):
    under a dry sink (``_cost.dry()``) the call returns ``outputs(*args,
    **kwargs)``, empty tensors of the kernel's output shapes and dtypes
    on the inputs' device, and neither checks, builds, loads nor
    launches anything."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _cost.dry():
                return outputs(*args, **kwargs)
            return fn(*args, **kwargs)
        return call
    return wrap


def empty(like: torch.Tensor, *shape: int,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """An uninitialised output of ``shape`` on ``like``'s device."""
    return torch.empty(shape, dtype=dtype, device=like.device)


def storage_name(t: torch.Tensor) -> str:
    """``STORAGE``'s name of ``t``'s dtype: the key of a wrapper's
    ``launches_by_dtype``."""
    return STORAGE[t.dtype]


def launched() -> int:
    """What a wrapper adds to its launch count after a launch function
    returns: 1, or 0 under a dry sink, which launched nothing."""
    return 0 if _cost.dry() else 1


def runs_plain(t: torch.Tensor) -> bool:
    """Whether a public wrapper takes its plain version for ``t``: only
    for a tensor on the CPU. Any other tensor launches the kernel."""
    return t.device.type == "cpu"


def trains(*tensors) -> bool:
    """Whether a call on these inputs must carry a gradient: grad mode is
    on and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors, why: str = "the CUDA kernel has no "
                "backward") -> None:
    """The CUDA branch of a public wrapper that cannot carry a gradient
    for this call (the one-hot pair, the resident stack, the padded-table
    aggregation, whose Pallas counterparts the JAX package cannot
    differentiate either; a gather's scale gradient over an int8 table,
    which training never asks for): a launch on an input that requires
    grad in grad mode would hand back an output with no autograd history
    and silently lose its gradients. Raise instead."""
    if trains(*tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but {why} (ROADMAP item 12e, "
            "not a port: the JAX package cannot differentiate its Pallas "
            "counterpart either): its output would carry no gradient. "
            "Call it under torch.no_grad() or torch.inference_mode(), or "
            "on CPU tensors, whose plain version is differentiable")


def pointer(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_pointer(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``: kernels launch on it and
    never synchronise."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
