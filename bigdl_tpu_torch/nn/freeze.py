"""Layer freezing — the port of ``bigdl_tpu.nn.freeze``: a module marked
``mod.trainable = False`` freezes every parameter under it.

``trainable_mask_for`` gives the JAX-keyed tree of the model's
parameters with one bool a leaf (False: frozen), the ``trainable_mask``
that ``Optimizer`` and ``TrainStep`` take; ``Optimizer`` derives it by
itself when ``has_frozen``.  The step zeroes frozen gradients and puts
frozen parameters back bit for bit after each update."""

from typing import Any, Dict

from torch import nn

from bigdl_tpu_torch.utils.convert import nest

__all__ = ["trainable_mask_for", "has_frozen"]


def _frozen_prefixes(module: nn.Module):
    return [name for name, m in module.named_modules()
            if getattr(m, "trainable", True) is False]


def trainable_mask_for(module: nn.Module) -> Dict[str, Any]:
    """Bool tree matching ``module``'s params tree: False under modules
    whose ``trainable`` is False (inherited by every descendant)."""
    frozen = _frozen_prefixes(module)

    def trains(name: str) -> bool:
        return not any(p == "" or name == p or name.startswith(p + ".")
                       for p in frozen)

    return nest((n, trains(n)) for n, _ in module.named_parameters())


def has_frozen(module: nn.Module) -> bool:
    """Whether any module of the tree is marked ``trainable = False``."""
    return bool(_frozen_prefixes(module))
