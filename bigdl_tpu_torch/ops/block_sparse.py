"""Block-sparse matmul, ``BlockSparseLinear`` and magnitude block pruning
— the port of ``bigdl_tpu.ops.block_sparse``.

:func:`block_sparse_matmul` computes ``x (..., K) @ (w ⊙ mask) (K, N)``
for a host bool block mask of shape ``(ceil(K/block_k), ceil(N/block_n))``
and skips the pruned blocks: on CUDA through the hand-written kernel
``csrc/block_sparse_matmul.cu``, which walks each output column block's
kept k-blocks from a column plan (``counts``, ``idx``); on the CPU through
its plain version, the masked dense product.  It is differentiable: dx is
the same kernel on the transposed plan, dw the dense product masked on
the way out, as the JAX VJP splits it.

The column plan is built on the host from the mask and uploaded to a
device once: :class:`ColumnPlan` keeps it per device, and
:class:`BlockSparseLinear` keeps its plan until its mask changes.

Mask derivation (``prune_to``) stays in numpy, the JAX package's own
code, so the masks are the JAX ones.  A torch module owns its weight, so
pruning reads the module's parameter itself: there is no params tree to
bind by order."""

import ctypes
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from bigdl_tpu_torch.nn.layers import Linear
from bigdl_tpu_torch.ops.common import cdiv, launch
from bigdl_tpu_torch.tensor.policy import cast_compute

KERNEL = "block_sparse_matmul"
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, counts, idx, max_count, out, M, K, N, block_k, block_n
_SIGNATURE = (KERNEL, "block_sparse_matmul_f32",
              [_P] * 4 + [_I, _P] + [_I] * 5)


class StaticMask:
    """Hashable wrapper of a host bool block mask: two masks with equal
    bytes hash equal."""

    __slots__ = ("arr", "_hash")

    def __init__(self, arr):
        self.arr = np.ascontiguousarray(np.asarray(arr, bool))
        self._hash = hash((self.arr.shape, self.arr.tobytes()))

    @property
    def shape(self):
        return self.arr.shape

    def density(self) -> float:
        return float(self.arr.mean()) if self.arr.size else 1.0

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return (isinstance(other, StaticMask)
                and self.arr.shape == other.arr.shape
                and bool(np.array_equal(self.arr, other.arr)))

    def __repr__(self):
        return (f"StaticMask({self.arr.shape}, "
                f"density={self.density():.3f})")


def expand_mask(mask, k: int, n: int, block_k: int,
                block_n: int) -> np.ndarray:
    """Block mask -> elementwise (k, n) mask (the dense view)."""
    arr = mask.arr if isinstance(mask, StaticMask) else np.asarray(mask,
                                                                   bool)
    full = np.repeat(np.repeat(arr, block_k, 0), block_n, 1)
    return full[:k, :n]


def _column_plan(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per output-column block: its kept k-block count and the padded
    list of their indices, in increasing order."""
    nkb, nnb = arr.shape
    counts = arr.sum(0).astype(np.int32)
    maxc = max(1, int(counts.max()) if counts.size else 1)
    idx = np.zeros((nnb, maxc), np.int32)
    for j in range(nnb):
        nz = np.nonzero(arr[:, j])[0]
        idx[j, : len(nz)] = nz
    return counts, idx


class ColumnPlan:
    """The column plan of one block mask and of its transpose (for the
    backward's dx), built on the host once and uploaded to each device
    once."""

    def __init__(self, mask, block_k: int, block_n: int):
        self.mask = mask if isinstance(mask, StaticMask) else StaticMask(mask)
        self.block_k, self.block_n = int(block_k), int(block_n)
        self.counts, self.idx = _column_plan(self.mask.arr)
        self._t: Optional["ColumnPlan"] = None
        self._dev: Dict[torch.device, tuple] = {}

    def transposed(self) -> "ColumnPlan":
        if self._t is None:
            self._t = ColumnPlan(self.mask.arr.T, self.block_n, self.block_k)
        return self._t

    def on(self, device: torch.device, k: int, n: int):
        """(counts, idx, elementwise mask) as tensors on ``device``."""
        key = (device, k, n)
        if key not in self._dev:
            self._dev[key] = (
                torch.from_numpy(self.counts).to(device),
                torch.from_numpy(self.idx).to(device),
                torch.from_numpy(expand_mask(self.mask, k, n, self.block_k,
                                             self.block_n)).to(device))
        return self._dev[key]


def block_sparse_matmul_ref(x, w, plan: ColumnPlan) -> torch.Tensor:
    """Plain version: ``x (M, K) @ (w masked to the kept blocks)`` in
    float32 (the masked dense product)."""
    k, n = w.shape
    em = plan.on(x.device, k, n)[2]
    return torch.matmul(x.float(), torch.where(em, w.float(), 0.0))


def _bs_raw(x, w, plan: ColumnPlan) -> torch.Tensor:
    """One product on ``x``'s device: the kernel for CUDA tensors, the
    plain version for CPU ones."""
    if x.device != w.device:
        raise ValueError(f"x and w must be on one device, got {x.device} "
                         f"and {w.device}")
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         f"chain")
    if plan.mask.shape != (cdiv(k, plan.block_k), cdiv(n, plan.block_n)):
        raise ValueError(
            f"mask {plan.mask.shape} does not tile ({k}, {n}) in "
            f"({plan.block_k}, {plan.block_n}) blocks: want "
            f"({cdiv(k, plan.block_k)}, {cdiv(n, plan.block_n)})")
    if x.device.type == "cpu":
        return block_sparse_matmul_ref(x, w, plan)
    if x.device.type != "cuda":
        raise ValueError(f"block_sparse_matmul runs on CUDA tensors "
                         f"(kernel) or CPU tensors (plain version), got "
                         f"{x.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"the kernel takes float32, got {x.dtype} and "
                         f"{w.dtype}")
    x = x.contiguous()
    w = w.contiguous()
    counts, idx, _ = plan.on(x.device, k, n)
    out = x.new_empty((m, n))
    launch(KERNEL, _SIGNATURE, x.device, x.data_ptr(), w.data_ptr(),
           counts.data_ptr(), idx.data_ptr(), idx.shape[1], out.data_ptr(),
           m, k, n, plan.block_k, plan.block_n)
    return out


class _BlockSparseMatmul(torch.autograd.Function):
    """The block-sparse product with its own backward, as the JAX
    package's ``custom_vjp``: dx = g @ (w ⊙ mask)ᵀ through the kernel on
    the transposed plan, dw = (xᵀ g) ⊙ mask dense."""

    @staticmethod
    def forward(ctx, x, w, plan):
        ctx.save_for_backward(x, w)
        ctx.plan = plan
        return _bs_raw(x, w, plan)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        plan = ctx.plan
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _bs_raw(g.float(), w.float().t().contiguous(),
                         plan.transposed()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            k, n = w.shape
            em = plan.on(w.device, k, n)[2]
            dw = torch.where(em, torch.matmul(x.float().t(), g.float()),
                             0.0).to(w.dtype)
        return dx, dw, None


def block_sparse_matmul(x, w, mask=None, *, block_k: int = 0,
                        block_n: int = 0, plan: Optional[ColumnPlan] = None):
    """``x (…, K) @ (w ⊙ mask) (K, N)``, skipping pruned weight blocks.

    ``mask`` is a host bool array (ceil(K/block_k), ceil(N/block_n)) or a
    :class:`StaticMask`; or pass a prepared ``plan`` instead (its device
    copy is reused across calls).  Differentiable.  Returns float32
    (…, N)."""
    if plan is None:
        if mask is None or not block_k or not block_n:
            raise ValueError("block_sparse_matmul needs a plan, or a mask "
                             "with block_k and block_n")
        plan = ColumnPlan(mask, block_k, block_n)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    out = _BlockSparseMatmul.apply(x2, w, plan)
    return out.reshape(*lead, w.shape[1])


# ---------------------------------------------------------------------------
# BlockSparseLinear module
# ---------------------------------------------------------------------------

class BlockSparseLinear(Linear):
    """:class:`~bigdl_tpu_torch.nn.layers.Linear` with a block-prunable
    weight.  Starts DENSE (an all-ones mask: exactly Linear's forward);
    after :meth:`set_mask` or :meth:`prune_to` the forward goes through
    :func:`block_sparse_matmul` (its kernel on CUDA tensors, its plain
    version on CPU tensors).  The mask is host numpy on the module; its
    column plan is built and uploaded once per mask."""

    def __init__(self, in_features: int, out_features: int,
                 block_shape: Tuple[int, int] = (64, 64),
                 target_sparsity: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features, generator=generator)
        self.block_shape = (int(block_shape[0]), int(block_shape[1]))
        self.target_sparsity = float(target_sparsity)
        bk, bn = self.block_shape
        self._plan: Optional[ColumnPlan] = None
        self.mask = np.ones((cdiv(in_features, bk),
                             cdiv(out_features, bn)), bool)

    @property
    def mask(self) -> np.ndarray:
        return self._mask

    @mask.setter
    def mask(self, arr) -> None:
        self._mask = np.asarray(arr, bool)
        self._plan = None        # rebuilt (and uploaded) at next use

    def set_mask(self, mask) -> None:
        arr = np.asarray(mask, bool)
        if arr.shape != self._mask.shape:
            raise ValueError(f"mask {arr.shape} != expected "
                             f"{self._mask.shape}")
        self.mask = arr

    def density(self) -> float:
        return float(self._mask.mean())

    def sparsity(self) -> float:
        return 1.0 - self.density()

    def plan(self) -> ColumnPlan:
        if self._plan is None:
            self._plan = ColumnPlan(self._mask, *self.block_shape)
        return self._plan

    def prune_to(self, sparsity: float) -> float:
        """Magnitude block pruning of the module's own weight: keep the
        highest-L1 blocks so that ``1 - sparsity`` of ALL blocks
        survive.  Monotone: only kept blocks are candidates.  Returns
        the achieved sparsity."""
        bk, bn = self.block_shape
        w = self.weight.detach().float().cpu().numpy()
        k, n = w.shape
        nkb, nnb = self._mask.shape
        wp = np.zeros((nkb * bk, nnb * bn), np.float32)
        wp[:k, :n] = np.abs(w)
        scores = wp.reshape(nkb, bk, nnb, bn).sum(axis=(1, 3))
        total = self._mask.size
        n_keep = max(1, int(round((1.0 - float(sparsity)) * total)))
        kept = int(self._mask.sum())
        if n_keep >= kept:
            return self.sparsity()   # already at or past this level
        flat = np.where(self._mask.ravel(), scores.ravel(), -np.inf)
        order = np.argsort(flat)[::-1]
        new = np.zeros(total, bool)
        new[order[:n_keep]] = True
        self.mask = new.reshape(self._mask.shape)
        return self.sparsity()

    def forward(self, x):
        if bool(self._mask.all()):
            return super().forward(x)     # dense warmup: exactly Linear
        xc, wc = cast_compute(x, self.weight)
        y = block_sparse_matmul(xc, wc, plan=self.plan())
        return (y.float() + self.bias).to(x.dtype)


# ---------------------------------------------------------------------------
# model-level pruning helpers + schedule
# ---------------------------------------------------------------------------

def iter_sparse_modules(model: torch.nn.Module):
    """Every :class:`BlockSparseLinear` in a module tree, as ``(path,
    module)`` pairs in module order."""
    for path, mod in model.named_modules():
        if isinstance(mod, BlockSparseLinear):
            yield path, mod


def prune_model_to_sparsity(model: torch.nn.Module,
                            sparsity: float) -> Dict[str, float]:
    """One pruning EVENT: every :class:`BlockSparseLinear` prunes its own
    weight to ``min(sparsity, target_sparsity)`` by block magnitude.
    Returns ``{path: achieved_sparsity}``."""
    out: Dict[str, float] = {}
    for path, mod in iter_sparse_modules(model):
        goal = min(float(sparsity), mod.target_sparsity or float(sparsity))
        out[path] = mod.prune_to(goal)
    return out


def derive_draft_masks(model: torch.nn.Module,
                       sparsity: float) -> Dict[str, float]:
    """Masks of a speculative DRAFT twin from the served weights: every
    sparse layer of ``model`` (whose weights are the served model's own
    parameters) starts from the all-ones mask and prunes once to
    ``sparsity``.  Returns ``{path: achieved_sparsity}``."""
    for _, mod in iter_sparse_modules(model):
        mod.mask = np.ones_like(mod.mask)
    return prune_model_to_sparsity(model, float(sparsity))


def collect_masks(model: torch.nn.Module) -> Dict[str, Any]:
    """Serializable ``{path: mask-as-list}`` snapshot."""
    return {path: mod.mask.tolist()
            for path, mod in iter_sparse_modules(model)}


def apply_masks(model: torch.nn.Module, masks: Dict[str, Any]) -> int:
    """Restore masks captured by :func:`collect_masks`.  Returns how many
    modules matched."""
    n = 0
    for path, mod in iter_sparse_modules(model):
        if path in masks:
            mod.set_mask(np.asarray(masks[path], bool))
            n += 1
    return n


class BlockPruningSchedule:
    """Dense warmup, then gradual magnitude pruning: ``sparsity_at(step)``
    is 0 through ``warmup_steps``, then ramps to ``target_sparsity`` over
    ``ramp_steps`` in ``n_events`` equal jumps of a cubic ramp.
    ``prune_steps()`` lists the steps where the mask changes."""

    def __init__(self, target_sparsity: float, warmup_steps: int,
                 ramp_steps: int, n_events: int = 4):
        if not 0.0 <= target_sparsity < 1.0:
            raise ValueError(f"target_sparsity {target_sparsity}: [0, 1)")
        if warmup_steps < 0 or ramp_steps < 0 or n_events < 1:
            raise ValueError("warmup/ramp steps >= 0, n_events >= 1")
        self.target_sparsity = float(target_sparsity)
        self.warmup_steps = int(warmup_steps)
        self.ramp_steps = int(ramp_steps)
        self.n_events = int(n_events)

    def _ramp(self, frac: float) -> float:
        frac = min(max(frac, 0.0), 1.0)
        return self.target_sparsity * (1.0 - (1.0 - frac) ** 3)

    def sparsity_at(self, step: int) -> float:
        if step < self.warmup_steps or self.target_sparsity == 0.0:
            return 0.0
        if self.ramp_steps == 0:
            return self.target_sparsity
        frac = (step - self.warmup_steps) / self.ramp_steps
        event = min(self.n_events, int(np.floor(frac * self.n_events)) + 1)
        return self._ramp(event / self.n_events)

    def prune_steps(self):
        if self.target_sparsity == 0.0:
            return []
        if self.ramp_steps == 0:
            return [self.warmup_steps]
        steps, prev = [], 0.0
        for s in range(self.warmup_steps,
                       self.warmup_steps + self.ramp_steps + 1):
            cur = self.sparsity_at(s)
            if cur > prev:
                steps.append(s)
                prev = cur
        return steps
