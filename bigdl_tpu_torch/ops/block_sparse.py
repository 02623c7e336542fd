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
device once: :class:`ColumnPlan` keeps it per device, with the 64-bit
row mask of every (64-row chunk, column block) pair that the bfloat16
kernel reads, and :class:`BlockSparseLinear` keeps its plan until its
mask changes.  :func:`bf16_plan` picks the bfloat16 kernel's path, tile
and split of K from the shape.

Mask derivation (``prune_to``) stays in numpy, the JAX package's own
code, so the masks are the JAX ones.  A torch module owns its weight, so
pruning reads the module's parameter itself: there is no params tree to
bind by order."""

import ctypes
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from bigdl_tpu_torch.nn.layers import Linear
from bigdl_tpu_torch.ops.common import (cdiv, is_dtensor, launch,
                                        refuse_dtensor)
from bigdl_tpu_torch.tensor.policy import cast_compute

KERNEL = "block_sparse_matmul"
KERNEL_BF16 = "block_sparse_matmul_bf16"
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, counts, idx, max_count, out, M, K, N, block_k, block_n
_F32 = (KERNEL, "block_sparse_matmul_f32", [_P] * 4 + [_I, _P] + [_I] * 5)
# x, w, counts, idx, max_count, masks, out, ws, counters, M, K, N, block_k,
# block_n, tile_m, chunks_per_split
_BF16 = (KERNEL, "block_sparse_matmul_bf16",
         [_P] * 4 + [_I] + [_P] * 4 + [_I] * 7)
_DTYPES = (torch.float32, torch.bfloat16)

# the bfloat16 kernel's geometry (csrc/block_sparse_matmul.cu, namespace
# wg): K walked in chunks of 64 rows, 64 output columns a tile
CHUNK = 64
TILE_N = 64
# streaming multiprocessors of an H100 SXM: the blocks a split aims to fill
SMS = 132
# at most 16 splits a tile, and (where more splits remain) at most 12
# chunks a split: the ring of the 16-row tiles holds 12, and on the card
# 12 chunks a split beat 16 at the prefill's (256, 3072, 768)
MAX_SPLITS = 16
MAX_CHUNKS = 12


class Bf16Plan(NamedTuple):
    """How the bfloat16 kernel runs one product: ``path`` "wgmma" (tiles
    of ``TILE_N`` output columns x ``tile_m`` rows of x, K split into
    ``splits`` runs of ``chunks_per_split`` 64-row chunks, ``blocks``
    blocks) or "mma_sync" (the general kernel, for shapes wgmma's copies
    cannot take)."""
    path: str
    tile_m: int
    chunks_per_split: int
    splits: int
    blocks: int


def bf16_plan(m: int, k: int, n: int, block_n: int, aligned: bool = True,
              sms: int = SMS) -> Bf16Plan:
    """The bfloat16 kernel's path, tile and split of K for ``x (m, k) @ w
    (k, n)`` in column blocks of ``block_n`` (``aligned``: x and w start
    on 16 bytes).  wgmma takes K, N and block_n multiples of 8 (16-byte
    copies of whole rows, 8 columns in one block) and a nonzero K; the
    C entry makes the same choice.  Its tile is 64 columns by the fewest
    of 16, 32 or 64 rows that holds m.  A product of fewer than ``sms``
    tiles splits K into runs of whole chunks, as even as they go: the
    fewest runs (at most 16) that give ``sms`` blocks of at most 12
    chunks, so that it still fills the card."""
    if not (k > 0 and k % 8 == 0 and n % 8 == 0 and block_n % 8 == 0
            and aligned):
        return Bf16Plan("mma_sync", 0, 0, 1, 0)
    tile_m = 16 if m <= 16 else 32 if m <= 32 else 64
    tiles = cdiv(m, tile_m) * cdiv(n, TILE_N)
    nchunks = cdiv(k, CHUNK)
    if tiles >= sms:
        return Bf16Plan("wgmma", tile_m, nchunks, 1, tiles)
    for want in range(1, min(nchunks, MAX_SPLITS) + 1):
        cps = cdiv(nchunks, want)
        splits = cdiv(nchunks, cps)
        if tiles * splits >= sms and cps <= MAX_CHUNKS:
            break
    return Bf16Plan("wgmma", tile_m, cps, splits, tiles * splits)


_sm_counts: Dict[torch.device, int] = {}
# the split kernel's per-tile arrival counters, by (device, stream): zeroed
# once, and set back to 0 by the last split of each tile at every launch,
# so a captured graph's replays find them clean.  Launches that share a
# stream are ordered; two streams get two sets.
_COUNTERS = 1024
_counters: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _sms(device: torch.device) -> int:
    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_counts[device]


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


def row_masks(arr: np.ndarray, k: int, block_k: int) -> np.ndarray:
    """Which rows each column block keeps, a 64-bit mask per (64-row
    chunk, column block): int64 (ceil(k / 64), column blocks), bit r of
    [c, j] set where row 64 c + r < k lies in a kept block of column
    block j."""
    nnb = arr.shape[1]
    nch = cdiv(k, CHUNK)
    rows = np.zeros((nch * CHUNK, nnb), bool)
    rows[:k] = np.repeat(arr, block_k, 0)[:k]
    bits = (rows.reshape(nch, CHUNK, nnb).astype(np.uint64)
            << np.arange(CHUNK, dtype=np.uint64)[None, :, None])
    return np.bitwise_or.reduce(bits, axis=1).view(np.int64)


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
        """(counts, idx, elementwise mask, row masks) as tensors on
        ``device``, each uploaded once."""
        key = (device, k, n)
        if key not in self._dev:
            self._dev[key] = (
                torch.from_numpy(self.counts).to(device),
                torch.from_numpy(self.idx).to(device),
                torch.from_numpy(expand_mask(self.mask, k, n, self.block_k,
                                             self.block_n)).to(device),
                torch.from_numpy(row_masks(self.mask.arr, k,
                                           self.block_k)).to(device))
        return self._dev[key]


def block_sparse_matmul_ref(x, w, plan: ColumnPlan) -> torch.Tensor:
    """Plain version: ``x (M, K) @ (w masked to the kept blocks)``, the
    masked dense product of the operands widened to float32, in x's
    dtype (bfloat16 operands: one rounding of the float32 product, as
    the Pallas kernel writes ``x.dtype``)."""
    k, n = w.shape
    em = plan.on(x.device, k, n)[2]
    y = torch.matmul(x.float(), torch.where(em, w.float(), 0.0))
    return y.to(x.dtype)


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
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise ValueError(f"block_sparse_matmul takes float32 or bfloat16 "
                         f"operands of one dtype, got {x.dtype} and "
                         f"{w.dtype}")
    if x.device.type == "cpu":
        return block_sparse_matmul_ref(x, w, plan)
    if x.device.type != "cuda":
        raise ValueError(f"block_sparse_matmul runs on CUDA tensors "
                         f"(kernel) or CPU tensors (plain version), got "
                         f"{x.device}")
    x = x.contiguous()
    w = w.contiguous()
    if x.dtype == torch.bfloat16:
        return _bs_bf16(x, w, plan, bf16_plan(
            m, k, n, plan.block_n, _aligned(x, w), _sms(x.device)))
    counts, idx, _, _ = plan.on(x.device, k, n)
    out = x.new_empty((m, n))
    launch(KERNEL, _F32, x.device, x.data_ptr(), w.data_ptr(),
           counts.data_ptr(), idx.data_ptr(), idx.shape[1], out.data_ptr(),
           m, k, n, plan.block_k, plan.block_n)
    return out


def _aligned(x, w) -> bool:
    return x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0


def _bs_bf16(x, w, plan: ColumnPlan, tp: Bf16Plan) -> torch.Tensor:
    """The bfloat16 kernel on contiguous CUDA operands under the tile plan
    ``tp`` (``bf16_plan``'s), with its float32 workspace of split sums."""
    m, k = x.shape
    n = w.shape[1]
    counts, idx, _, masks = plan.on(x.device, k, n)
    out = x.new_empty((m, n))
    ws = counters = None
    if tp.splits > 1:
        ws = torch.empty((tp.splits, m, n), dtype=torch.float32,
                         device=x.device)
        key = (x.device, torch.cuda.current_stream(x.device).cuda_stream)
        if key not in _counters:
            _counters[key] = torch.zeros(_COUNTERS, dtype=torch.int32,
                                         device=x.device)
        counters = _counters[key].data_ptr()
    launch(KERNEL_BF16, _BF16, x.device, x.data_ptr(), w.data_ptr(),
           counts.data_ptr(), idx.data_ptr(), idx.shape[1], masks.data_ptr(),
           out.data_ptr(), None if ws is None else ws.data_ptr(), counters,
           m, k, n, plan.block_k, plan.block_n, tp.tile_m,
           tp.chunks_per_split)
    return out


class _BlockSparseMatmul(torch.autograd.Function):
    """The block-sparse product with its own backward, as the JAX
    package's ``custom_vjp``: dx = g @ (w ⊙ mask)ᵀ through the float32
    kernel on the transposed plan, dw = (xᵀ g) ⊙ mask dense in float32,
    each rounded to its operand's dtype."""

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
    copy is reused across calls).  ``x`` and ``w`` are both float32 or
    both bfloat16 (float32 sums either way).  Differentiable.  Returns
    (…, N) in x's dtype."""
    refuse_dtensor("block_sparse_matmul", x, w)
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
        w = self.weight.detach()
        if is_dtensor(w):
            w = w.full_tensor()      # a layout's weight, whole
        w = w.float().cpu().numpy()
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
        if is_dtensor(wc):
            # a layout: the kernel on the whole operands
            from bigdl_tpu_torch.parallel import local_ops

            plan = self.plan()
            y = local_ops.block_sparse(
                lambda a, b: block_sparse_matmul(a, b, plan=plan), xc, wc)
        else:
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
