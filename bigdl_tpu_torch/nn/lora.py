"""LoRA, low-rank adaptation for parameter-efficient fine-tuning — the
port of ``bigdl_tpu.nn.lora``.

:func:`apply_lora` wraps every selected ``Linear`` in a twin computing
``y = x W + (alpha / r) x A B``, where the base weight stays frozen and
only the adapters ``lora_a`` (in, r) and ``lora_b`` (r, out) train.
:func:`lora_filter` gives the bool tree that freezes everything else
(the ``trainable_mask`` of ``Optimizer`` and ``ShardedParameterStep``),
and :func:`merge_lora` folds trained adapters back into plain ``Linear``
weights, so serving (int8 too) sees an ordinary model.

A twin holds its layer as the child ``inlined`` (the JAX paths leave it
out, ``utils.convert``), so the base parameters keep their JAX keys and
the adapters sit beside them (``0_Linear/lora_a``), as in the JAX
params tree.  The walk is the port's ``quantize``'s: every ``Linear`` of
the module tree (a keras ``Model``'s node layers)."""

import copy
from typing import Any, Callable, Dict, Optional

import torch

from bigdl_tpu_torch.nn.layers import Linear
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.quantized import swap_leaves
from bigdl_tpu_torch.tensor.policy import cast_compute, matmul_f32
from bigdl_tpu_torch.utils.convert import jax_path, nest

__all__ = ["LoRALinear", "apply_lora", "merge_lora", "lora_filter"]

_ADAPTERS = ("lora_a", "lora_b")


class LoRALinear(Module):
    """``Linear`` plus a trainable low-rank bypass.  ``lora_a`` starts
    N(0, 1) / r from ``generator`` and ``lora_b`` at zero, so the bypass
    starts as the identity (a zero delta), the standard LoRA init."""

    def __init__(self, inner: Linear, rank: int = 8, alpha: float = 16.0,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name or inner.name)
        self.inlined = inner
        self.rank = int(rank)
        self.alpha = float(alpha)
        w = inner.weight
        a = torch.randn((w.shape[0], self.rank), generator=generator,
                        dtype=torch.float32) / max(1, self.rank)
        self.lora_a = torch.nn.Parameter(a.to(w.device))
        self.lora_b = torch.nn.Parameter(torch.zeros(
            (self.rank, inner.out_features), dtype=torch.float32,
            device=w.device))

    @property
    def scale(self) -> float:
        return self.alpha / max(1, self.rank)

    def forward(self, x):
        y = self.inlined(x)
        xc, a, b = cast_compute(x, self.lora_a, self.lora_b)
        delta = matmul_f32(torch.matmul(xc, a), b)
        return (y.float() + self.scale * delta).to(x.dtype)


def apply_lora(module: torch.nn.Module, rank: int = 8, alpha: float = 16.0,
               generator: Optional[torch.Generator] = None,
               match: Optional[Callable[[Linear], bool]] = None
               ) -> torch.nn.Module:
    """A new module (the caller's is left as it is) in which every
    ``Linear`` that ``match`` accepts (default: all) is a
    :class:`LoRALinear` over a copy of it, the adapters drawn from
    ``generator`` in module order (a seeded default when None).  Train
    it with :func:`lora_filter` as the trainable mask."""
    g = generator
    if g is None:
        g = torch.Generator().manual_seed(0)

    def fn(mod):
        if not isinstance(mod, Linear) or (match and not match(mod)):
            return None
        return LoRALinear(copy.deepcopy(mod), rank=rank, alpha=alpha,
                          generator=g)

    return swap_leaves(module, fn)


def lora_filter(params) -> Dict[str, Any]:
    """The bool tree of a params tree (a module's parameters, or a
    JAX-keyed tree): True on the adapter leaves, False elsewhere."""
    if isinstance(params, torch.nn.Module):
        return nest((n, jax_path(n)[-1] in _ADAPTERS)
                    for n, _ in params.named_parameters())

    def rec(tree, key=None):
        if isinstance(tree, dict):
            return {k: rec(v, k) for k, v in tree.items()}
        return key in _ADAPTERS

    return rec(params)


def merge_lora(module: torch.nn.Module) -> torch.nn.Module:
    """Fold trained adapters into the dense weights, ``W' = W + (alpha /
    r) A B``: a new module whose :class:`LoRALinear` leaves are plain
    ``Linear`` layers again."""

    def fn(mod):
        if not isinstance(mod, LoRALinear):
            return None
        lin = copy.deepcopy(mod.inlined)
        with torch.no_grad():
            w = lin.weight
            merged = w.float() + mod.scale * torch.matmul(
                mod.lora_a.float(), mod.lora_b.float())
            w.copy_(merged.to(w.dtype))
        return lin

    return swap_leaves(module, fn)
