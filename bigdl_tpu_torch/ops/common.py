"""Shared helpers for the kernel layer: device resolution and the launch
counts every kernel wrapper keeps."""

from collections import Counter

import torch

# Launches of each hand-written kernel, by kernel name.  A wrapper adds
# one here right after its kernel launched, and nowhere else, so a run
# can show that its main path really went through the kernels.
LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


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
