"""Shared helpers for the kernel layer: device resolution, the launch of
a built kernel's C entry point, and the launch counts every kernel wrapper
keeps."""

import ctypes
from collections import Counter
from typing import Dict, Sequence, Tuple

import torch

from bigdl_tpu_torch.ops import _build

# Launches of each hand-written kernel, by kernel name.  A wrapper adds
# one here right after its kernel launched, and nowhere else, so a run
# can show that its main path really went through the kernels.
LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


# (library, C symbol) -> (C function, error-string function)
_entries: Dict[Tuple[str, str], tuple] = {}


def launch(kernel: str, signature: Tuple[str, str, Sequence], device,
           *args) -> None:
    """Call the C entry point ``signature = (library in csrc/, symbol,
    argument types)`` with ``args`` and ``device``'s current stream,
    raise on a nonzero CUDA error, and count one launch of ``kernel``.
    The library is built and loaded at first use; its
    ``<library>_error`` function names the error."""
    lib_name, symbol, argtypes = signature
    if (lib_name, symbol) not in _entries:
        lib = _build.load(lib_name)
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes) + [ctypes.c_void_p]   # + the stream
        fn.restype = ctypes.c_int
        err_str = getattr(lib, f"{lib_name}_error")
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _entries[(lib_name, symbol)] = (fn, err_str)
    fn, err_str = _entries[(lib_name, symbol)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    LAUNCHES[kernel] += 1


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    asks for another.  Raises when CUDA is asked for (or defaulted to)
    and absent; the caller must pass ``device="cpu"`` to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b
