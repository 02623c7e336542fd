"""Weight-only int8 storage of a params tree — the port of
``bigdl_tpu.nn.quantized``'s raw param-tree quantization
(``quantize_params`` / ``dequantize_params`` / ``is_quantized_params``).

A params tree is a nested dict of tensors (``utils.convert.export_params``
keys, or a flat ``{name: tensor}`` dict of ``named_parameters()``).  Every
floating 2-D leaf with both dims >= ``min_dim`` (embedding, attention
projections, FFN weights) becomes ``{"__w8__": int8 (in, out), "scale":
float32 (out,)}``, per-out-column abs-max scales; biases and LayerNorm
vectors stay float32.  :class:`Int8Weights` holds a copy of a module
with its matmul weights that way at rest and lends the copy a float32
view for the length of a ``with`` block.  (The module-swap ``quantize()``
of layered models waits for the nn core of the port.)"""

import copy
import threading
from contextlib import contextmanager
from typing import Any, Dict

import torch

from bigdl_tpu_torch.ops.quantized import quantize_int8

_Q8_KEY = "__w8__"


def quantize_params(params: Dict[str, Any], min_dim: int = 16
                    ) -> Dict[str, Any]:
    """Weight-only int8 quantization of a params tree (a new tree; the
    input is not changed).  Idempotent on an already-quantized tree."""

    def rec(p):
        if isinstance(p, dict):
            if _Q8_KEY in p:
                return p
            return {k: rec(v) for k, v in p.items()}
        if (isinstance(p, torch.Tensor) and p.ndim == 2
                and p.shape[0] >= min_dim and p.shape[1] >= min_dim
                and p.is_floating_point()):
            w_q, scales = quantize_int8(p.detach().float(), axis=0)
            return {_Q8_KEY: w_q, "scale": scales}
        return p

    return rec(params)


def dequantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`quantize_params`: every ``__w8__`` subtree back
    to its float32 matrix."""

    def rec(p):
        if isinstance(p, dict):
            if _Q8_KEY in p:
                return p[_Q8_KEY].float() * p["scale"]
            return {k: rec(v) for k, v in p.items()}
        return p

    return rec(params)


def is_quantized_params(params) -> bool:
    """True when the tree holds at least one ``__w8__`` subtree."""
    if isinstance(params, dict):
        if _Q8_KEY in params:
            return True
        return any(is_quantized_params(v) for v in params.values())
    return False


class Int8Weights:
    """A copy of ``module`` whose matmul weights are stored int8 at rest.

    ``self.module`` is a twin of ``module`` (the caller's module and its
    parameters are left as they are).  In the twin every parameter
    :func:`quantize_params` quantizes starts as an empty tensor; its int8
    payload and scales are kept here.  ``with weights.view():`` gives
    each of them its dequantized float32 value for the length of the
    block and empties it again afterwards, so the float32 copy exists
    only while a call runs.  Other holders of the twin's ``Parameter``
    objects (a weight-sharing draft) see the same view.  A view is held
    by one thread at a time (an engine call, or a caller's forward
    between calls)."""

    def __init__(self, module: torch.nn.Module, min_dim: int = 16):
        named = dict(module.named_parameters())
        q = quantize_params(named, min_dim=min_dim)
        self._q = {}
        # the quantized leaves enter the copy as empty parameters, so
        # their float32 data is never duplicated
        memo = {}
        for name, leaf in q.items():
            if isinstance(leaf, dict):
                p = named[name]
                twin = torch.nn.Parameter(p.data.new_empty((0,)),
                                          requires_grad=p.requires_grad)
                memo[id(p)] = twin
                self._q[name] = (twin, leaf[_Q8_KEY], leaf["scale"])
        self.module = copy.deepcopy(module, memo)
        self._depth = 0
        self._lock = threading.RLock()

    @property
    def names(self):
        return sorted(self._q)

    def nbytes(self) -> int:
        """Bytes held at rest: int8 payloads and float32 scales."""
        return sum(w.numel() + 4 * s.numel() for _, w, s in self._q.values())

    @contextmanager
    def view(self):
        """Dequantized float32 weights for the length of the block
        (re-entrant: the outermost block builds and releases them; another
        thread's block waits for it)."""
        with self._lock:
            if self._depth == 0:
                with torch.no_grad():
                    for p, w, s in self._q.values():
                        p.data = w.float() * s
            self._depth += 1
            try:
                yield
            finally:
                self._depth -= 1
                if self._depth == 0:
                    for p, _, _ in self._q.values():
                        p.data = p.data.new_empty((0,))
