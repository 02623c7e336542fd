"""Keras autograd — the port of ``bigdl_tpu.keras.autograd``: custom
layers and losses written from tensor ops.

Each op of the set (``add`` … ``squeeze``) applied to a keras ``Node``
lifts the function into the graph through a ``Lambda`` module; applied
to tensors it runs eagerly.  ``CustomLoss`` wraps ``fn(y_true, y_pred)
-> scalar`` as a criterion for ``compile(loss=...)``; torch's autograd
differentiates it with the train step, as ``jax.grad`` does in the JAX
package."""

import torch

from bigdl_tpu_torch.keras.engine import Node
from bigdl_tpu_torch.nn.criterion import Criterion
from bigdl_tpu_torch.nn.module import Lambda


def _wrap(fn, name):
    """Lift ``fn`` over Nodes and constants into a graph Node, or apply
    it to tensors."""

    def op(*args, **kw):
        if not any(isinstance(a, Node) for a in args):
            return fn(*args, **kw)
        nodes = [a for a in args if isinstance(a, Node)]
        consts = [(i, a) for i, a in enumerate(args)
                  if not isinstance(a, Node)]

        def run(*xs):
            full = list(xs)
            for i, c in consts:
                full.insert(i, c)
            return fn(*full, **kw)

        return Lambda(run, name=name)(nodes if len(nodes) > 1 else nodes[0])

    op.__name__ = name
    return op


def _reduce(torch_fn):
    """A reduction with numpy's ``axis`` (None: every axis) and
    ``keepdims`` spelling."""

    def f(a, axis=None, keepdims=False):
        if axis is None:
            out = torch_fn(a)
            return out.reshape([1] * a.dim()) if keepdims else out
        return torch_fn(a, dim=axis, keepdim=keepdims)

    return f


def _clip(a, a_min=None, a_max=None):
    return torch.clamp(a, min=a_min, max=a_max)


def _pow(a, b):
    return torch.pow(a, b)


def _squeeze(a, axis=None):
    return a.squeeze() if axis is None else a.squeeze(axis)


# -- the reference AutoGrad op set --------------------------------------------
add = _wrap(lambda a, b: a + b, "add")
sub = _wrap(lambda a, b: a - b, "sub")
mul = _wrap(lambda a, b: a * b, "mul")
div = _wrap(lambda a, b: a / b, "div")
neg = _wrap(lambda a: -a, "neg")
abs = _wrap(torch.abs, "abs")  # noqa: A001 — reference name
square = _wrap(torch.square, "square")
sqrt = _wrap(torch.sqrt, "sqrt")
exp = _wrap(torch.exp, "exp")
log = _wrap(torch.log, "log")
pow = _wrap(_pow, "pow")  # noqa: A001 — reference name
maximum = _wrap(torch.maximum, "maximum")
minimum = _wrap(torch.minimum, "minimum")
clip = _wrap(_clip, "clip")
sum = _wrap(_reduce(torch.sum), "sum")  # noqa: A001 — reference name
mean = _wrap(_reduce(torch.mean), "mean")
softsign = _wrap(lambda a: a / (1 + torch.abs(a)), "softsign")
softplus = _wrap(lambda a: torch.logaddexp(a, torch.zeros_like(a)),
                 "softplus")
dot = _wrap(torch.matmul, "dot")
stack = _wrap(lambda *xs, axis=0: torch.stack(xs, dim=axis), "stack")
concatenate = _wrap(lambda *xs, axis=-1: torch.cat(xs, dim=axis),
                    "concatenate")
expand_dims = _wrap(lambda a, axis: a.unsqueeze(axis), "expand_dims")
squeeze = _wrap(_squeeze, "squeeze")


class CustomLoss(Criterion):
    """``fn(y_true, y_pred) -> scalar`` as a criterion."""

    def __init__(self, loss_fn, name: str = "custom_loss"):
        self.loss_fn = loss_fn
        self.name = name

    def forward(self, input, target):
        return self.loss_fn(target, input)


def mean_absolute_error(y_true, y_pred):
    return torch.mean(torch.abs(y_pred - y_true))


def mean_squared_error(y_true, y_pred):
    return torch.mean(torch.square(y_pred - y_true))


__all__ = ["CustomLoss", "abs", "add", "clip", "concatenate", "div", "dot",
           "exp", "expand_dims", "log", "maximum", "mean",
           "mean_absolute_error", "mean_squared_error", "minimum", "mul",
           "neg", "pow", "softplus", "softsign", "sqrt", "square", "squeeze",
           "stack", "sub", "sum"]
