"""Shared helpers for the kernel layer: device resolution, the launch of
a built kernel's C entry point, and the launch counts every kernel wrapper
keeps."""

import contextlib
import ctypes
import gc
import sys
from collections import Counter
from typing import Dict, Iterator, Sequence, Tuple

import torch

from bigdl_tpu_torch.ops import _build

# Launches of each hand-written kernel, by kernel name.  A wrapper adds
# one here right after its kernel launched, and nowhere else, so a run
# can show that its main path really went through the kernels.
LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


@contextlib.contextmanager
def captured_launches() -> Iterator[Counter]:
    """Around a CUDA-graph capture.  A capture runs the wrappers, which
    count, but launches nothing; a replay launches the captured kernels
    without running any wrapper.  So what the wrappers counted inside
    comes back in the yielded Counter and ``LAUNCHES`` is put back as it
    was; the caller adds the Counter at every replay
    (:func:`credit_launches`).

    Python's cyclic garbage collector is paused inside.  An engine or a
    train step that was dropped holds its graphs and their memory pool
    in reference cycles; a collection that ran during a capture would
    free them there, and those CUDA calls invalidate the capture
    (``cudaErrorStreamCaptureInvalidated``)."""
    before = Counter(LAUNCHES)
    captured: Counter = Counter()
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield captured
    finally:
        if collecting:
            gc.enable()
        captured.update(LAUNCHES - before)
        LAUNCHES.clear()
        LAUNCHES.update(before)


def credit_launches(captured: Counter) -> None:
    """Count one replay of a graph whose capture recorded ``captured``."""
    LAUNCHES.update(captured)


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


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (never true before DTensor's module is
    imported, so a run without a layout does not import it)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def refuse_dtensor(op: str, *tensors) -> None:
    """Raise when a DTensor reaches a kernel wrapper: the kernels (and
    their plain versions) take each rank's local tensors, so a layout
    reaches them through ``local_map`` (``parallel.local_ops``), never
    by falling back to another path."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(f"{op} takes plain tensors, got a DTensor: reach "
                        f"it through local_map (parallel.local_ops)")


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
