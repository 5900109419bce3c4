"""The launch seam: how a tensor becomes a counted, checked call into C.

Every wrapper of `ops/*_kernels.py` describes only its own kernel and
takes the rest from here: the entry points' device (`resolve_device`),
the route on its main tensor's device (`use_kernel`: a CUDA tensor
launches the kernel, a CPU tensor runs the plain version), the tensor
checks, the u32 helpers, and `launch`, which calls an entry of
``csrc/*.cu`` after range-checking every ``int`` and ``long long``
argument against the C type its source declares (`cuda_build.signatures`;
ctypes itself wraps a value that does not fit without a word) and counts
it as ``launches.<wrapper>`` (`counters`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import trace
from . import cuda_build

__all__ = [
    "M32",
    "resolve_device",
    "use_kernel",
    "check",
    "same_device",
    "to_i32",
    "u32",
    "as_device_bytes",
    "launch",
    "counters",
]

M32 = 0xFFFFFFFF

# the values each integer type of a C entry holds
_C_RANGES = {
    ctypes.c_int: (-(1 << 31), (1 << 31) - 1),
    ctypes.c_longlong: (-(1 << 63), (1 << 63) - 1),
}


def resolve_device(device) -> torch.device:
    """The entry points' device: CUDA unless the caller asks for the CPU.

    A CUDA device without a usable card raises here rather than running the
    plain versions quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "huffman_tpu_torch runs on a CUDA device by default, but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"the kernels run on CUDA or CPU tensors, not {x.device}")


def check(name, x, dtype, shape=None):
    """``x`` is a contiguous tensor of ``dtype`` (and of ``shape``)."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def same_device(ref, *xs):
    """Every tensor of ``xs`` lies on ``ref``'s device."""
    for x in xs:
        if x.device != ref.device:
            raise ValueError(f"tensors on {ref.device} and {x.device}")


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> the same bits as int32."""
    x = x & M32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> their u32 values in int64."""
    return x.to(torch.int64) & M32


def as_device_bytes(data, dev: torch.device) -> torch.Tensor:
    """A uint8 array or tensor as a flat contiguous uint8 tensor on ``dev``
    (a copy that crosses to the device is counted, `trace.to_device`)."""
    if isinstance(data, torch.Tensor):
        if data.dtype != torch.uint8:
            raise TypeError(f"data must be uint8, got {data.dtype}")
        return trace.to_device(data.reshape(-1), dev, "input").contiguous()
    arr = np.ascontiguousarray(np.asarray(data, np.uint8).reshape(-1))
    return trace.to_device(arr, dev, "input")


@functools.cache
def _entry(lib: str, entry: str):
    """(C function, arguments before the stream, (position, low, high) of
    each integer argument) of one entry, worked out when it first loads."""
    argtypes = cuda_build.signatures()[lib][entry]
    if not argtypes or argtypes[-1] is not ctypes.c_void_p:
        raise ValueError(f"{lib}.cu: {entry} must take the stream last")
    ints = tuple((i, *_C_RANGES[t]) for i, t in enumerate(argtypes[:-1])
                 if t in _C_RANGES)
    fn = getattr(cuda_build.load_kernels()[lib], entry)
    return fn, len(argtypes) - 1, ints


def launch(lib: str, entry: str, *args, like: torch.Tensor, counted) -> None:
    """Call ``entry`` of ``csrc/<lib>.cu`` with ``args`` and the current
    stream of ``like``'s device, and count it as a launch of the wrapper
    ``counted``.

    Raises ValueError, before the call, for a wrong number of arguments or
    an integer outside its C type, and RuntimeError for a non-zero return
    code; only a launch that succeeds is counted.  The checks read Python
    values only: no host sync, allocation or device op."""
    fn, n, ints = _entry(lib, entry)
    if len(args) != n:
        raise ValueError(f"{counted.__name__}: {entry} takes {n} arguments "
                         f"before the stream, got {len(args)}")
    for i, lo, hi in ints:
        if not lo <= args[i] <= hi:
            raise ValueError(f"{counted.__name__}: argument {i} of {entry} "
                             f"is {args[i]}, outside its C type's "
                             f"[{lo}, {hi}]")
    rc = fn(*args, torch.cuda.current_stream(like.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{counted.__name__}: CUDA launch failed (cudaError {rc})")
    trace.count(trace.LAUNCH + counted.__name__)


def counters(*wrappers):
    """(reset_launch_counts, launch_counts) of a kernel module's
    ``wrappers``: zero their counts, read them by wrapper name."""
    names = tuple(fn.__name__ for fn in wrappers)

    def reset_launch_counts() -> None:
        trace.reset_launches(names)

    def launch_counts() -> dict[str, int]:
        return trace.launches(names)

    return reset_launch_counts, launch_counts
