"""Analytic FLOPs/bytes cost model and the device peak table — the port
of ``bigdl_tpu.obs.cost``, the MFU denominator and numerator.

The cost of a model is derived once a run from the model itself: a walk
that records every module's input and output shapes (forward hooks)
turns them into per-layer FLOPs with the JAX package's formulas, keyed
on class names and parameter shapes.  The port keeps JAX's parameter
names and its (in, out) / (kh, kw, cin, cout) layouts, so the formulas
carry over unchanged.

The JAX walk is ``jax.eval_shape``: no compute and no compile.  The
port's walk is a batch-of-the-sample forward of a CPU copy of the model
in eval mode under ``torch.no_grad()``: the copy is made straight from
the parameters (nothing is duplicated on the card), its kernels' CPU
tensors take their plain versions (so no kernel launches and no launch
count moves), eval mode draws no dropout key and moves no BatchNorm
statistic, and the model itself is never run.  The driver runs it once,
before the first step, so before any capture.

Conventions (the JAX package's):

- forward FLOPs are model FLOPs (2 x MACs for matmul-family layers;
  elementwise layers count 2 a output element);
- training FLOPs = ``TRAIN_FLOPS_MULTIPLIER`` (3) x forward;
- MFU = achieved FLOP/s a device over the device's dense bfloat16 peak
  (:func:`peak_flops`), in a float32-pinned run as well.  Unknown
  devices (the CPU) give ``None`` unless ``BIGDL_TPU_PEAK_FLOPS`` /
  ``EngineConfig.peak_flops`` pins a peak.
- Products a container computes itself (the weight-tied output
  projection of ``Transformer``) count 0, as in JAX: only leaves whose
  class the formulas know count."""

import copy
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.utils.log import get_logger

log = get_logger("bigdl_tpu_torch.obs")

TRAIN_FLOPS_MULTIPLIER = 3.0

# dense bfloat16 matmul peak FLOP/s a device, keyed by substrings of the
# device name, first match wins.  The H100 rows are NVIDIA's data sheet
# (dense, no sparsity): the PCIe part first, then the SXM part, which
# reports "NVIDIA H100 80GB HBM3".  The TPU rows are the JAX package's,
# so a TPU device kind resolves as it does there.
PEAK_BF16_FLOPS: List[Tuple[str, float]] = [
    ("h100 pcie", 756e12),
    ("h100", 989e12),
    ("v6", 918e12),
    ("v5p", 459e12),
    ("v5 lite", 197e12),
    ("v5e", 197e12),
    ("v5", 459e12),
    ("v4 lite", 138e12),
    ("v4", 275e12),
    ("v3", 123e12),
    ("v2", 45e12),
]


def device_name(device=None) -> str:
    """The name :func:`peak_flops` reads: ``torch.cuda.get_device_name``
    for a CUDA device, ``"cpu"`` otherwise."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def peak_flops(device_kind: Optional[str],
               override: Optional[float] = None) -> Optional[float]:
    """Peak bfloat16 FLOP/s of one device.  Resolution order:
    ``BIGDL_TPU_PEAK_FLOPS`` > ``override`` (``EngineConfig.peak_flops``)
    > the device-name table > None."""
    env = os.environ.get("BIGDL_TPU_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            log.warning("BIGDL_TPU_PEAK_FLOPS=%r is not a float; ignored",
                        env)
    if override:
        return float(override)
    kind = (device_kind or "").lower()
    for key, peak in PEAK_BF16_FLOPS:
        if key in kind:
            return peak
    return None


@dataclass
class LayerCost:
    """One module's forward cost from its observed shapes."""

    name: str
    kind: str
    flops: float
    param_bytes: int
    out_elems: int
    # executed FLOPs: below ``flops`` only for block-sparse layers
    eff_flops: float = -1.0

    def __post_init__(self):
        if self.eff_flops < 0:
            self.eff_flops = self.flops


@dataclass
class CostReport:
    """Forward cost of one model on one batch shape."""

    layers: List[LayerCost] = field(default_factory=list)
    batch: int = 0

    @property
    def flops(self) -> float:
        """Forward model FLOPs, dense-equivalent."""
        return float(sum(l.flops for l in self.layers))

    @property
    def eff_flops(self) -> float:
        """Executed forward FLOPs (nonzero blocks only)."""
        return float(sum(l.eff_flops for l in self.layers))

    @property
    def param_bytes(self) -> int:
        return int(sum(l.param_bytes for l in self.layers))

    def train_flops(self) -> float:
        return TRAIN_FLOPS_MULTIPLIER * self.flops

    def train_eff_flops(self) -> float:
        """Executed training FLOPs: forward and input gradient at the
        effective count, the weight gradient dense (``2 eff + dense`` a
        layer; 3x for dense layers)."""
        return float(sum(2.0 * l.eff_flops + l.flops for l in self.layers))

    def per_sample_flops(self) -> float:
        return self.flops / max(self.batch, 1)


def iter_modules(module):
    """Every module of the tree, each once (``module.modules()``)."""
    return module.modules()


def _shape(a) -> Optional[Tuple[int, ...]]:
    s = getattr(a, "shape", None)
    if s is None:
        return None
    try:
        return tuple(int(d) for d in s)
    except TypeError:
        return None


def _elems(shape: Optional[Tuple[int, ...]]) -> int:
    if not shape:
        return 0
    return int(np.prod(shape))


def _out_shapes(y) -> List[Tuple[int, ...]]:
    if isinstance(y, (tuple, list)):
        return [s for s in (_shape(a) for a in y) if s is not None]
    s = _shape(y)
    return [s] if s is not None else []


# the JAX package's list: one cheap pass over the output, 2 FLOPs an
# element
_ELEMENTWISE_KINDS = frozenset({
    "BatchNorm", "_BN", "LayerNorm", "RMSNorm", "GroupNorm", "ReLU",
    "ReLU6", "GELU", "SiLU", "Sigmoid", "Tanh", "SoftMax", "LogSoftMax",
    "LeakyReLU", "ELU", "HardTanh", "PReLU", "SoftPlus", "SoftSign",
    "Dropout", "MaxPool2D", "AvgPool2D", "MaxPool1D", "AvgPool1D",
    "MaxPool3D", "AvgPool3D", "GlobalAvgPool2D", "GlobalMaxPool2D",
    "GlobalAvgPool1D", "GlobalMaxPool1D", "CAddTable", "CMulTable",
    "Scale", "Power", "Abs", "Clamp", "Sqrt", "Square",
})


def _attention_flops(mod, in_shapes, out_shapes, params) -> float:
    """MultiHeadAttention: the q/k/v/out projections and the two
    attention products, 2 FLOPs a MAC."""
    x = in_shapes[0] if in_shapes else None
    if x is None or len(x) < 3:
        return 0.0
    b, t = x[0], x[1]
    proj = 0.0
    for key in ("wq", "wk", "wv", "wo"):
        w = _shape(params.get(key))
        if w is not None:
            proj += 2.0 * b * t * _elems(w)
    h = getattr(mod, "hidden_size", None) or x[-1]
    return proj + 4.0 * b * t * t * h


def _layer_flops(mod, in_shapes, out_shapes, params) -> float:
    kind = type(mod).__name__
    out_e = sum(_elems(s) for s in out_shapes)
    if kind == "MultiHeadAttention":
        return _attention_flops(mod, in_shapes, out_shapes, params)
    if kind == "Embedding":
        return 0.0
    if kind == "DepthwiseConv2D":
        w = _shape(params.get("weight"))
        if w is not None and len(w) >= 2:
            return 2.0 * out_e * w[0] * w[1]
        return 0.0
    if kind in _ELEMENTWISE_KINDS:
        return 2.0 * out_e
    # matmul family: every output element is a dot product over the
    # weight's non-output dims
    w = _shape(params.get("weight"))
    if w is not None and len(w) >= 2 and out_shapes \
            and out_shapes[0] and out_shapes[0][-1] == w[-1]:
        return 2.0 * out_e * _elems(w[:-1])
    # containers, reshapes, unknown glue: children are recorded apart
    return 0.0


def _param_bytes(params: Dict[str, torch.Tensor]) -> int:
    return int(sum(t.numel() * t.element_size() for t in params.values()))


def _cpu_copy(model: torch.nn.Module) -> torch.nn.Module:
    """A CPU copy of ``model``: its parameters and buffers copied to the
    host one by one (the memo hands ``deepcopy`` the host tensors, so
    nothing is duplicated on the card), the rest deep-copied."""
    memo: Dict[int, Any] = {}
    with torch.no_grad():
        for p in model.parameters():
            memo[id(p)] = torch.nn.Parameter(p.detach().to("cpu", copy=True),
                                             requires_grad=p.requires_grad)
        for b in model.buffers():
            memo[id(b)] = b.detach().to("cpu", copy=True)
    return copy.deepcopy(model, memo).to("cpu")


def forward_costs(model: torch.nn.Module, *sample_inputs) -> CostReport:
    """Per-layer forward cost of ``model`` on the shapes of
    ``sample_inputs`` (tensors or arrays, any device): the shape walk of
    the module docstring on a CPU copy, every module's input and output
    shapes recorded by a forward hook.  Leaf formulas turn shapes into
    FLOPs; containers and unknown modules count 0 (their children are
    recorded apart)."""
    twin = _cpu_copy(model)
    twin.train(False)
    records: List[Tuple[Any, list, list, Dict[str, torch.Tensor]]] = []

    def hook(mod, args, out):
        records.append((mod, [_shape(a) for a in args], _out_shapes(out),
                        dict(mod.named_parameters(recurse=False))))

    handles = [m.register_forward_hook(hook) for m in iter_modules(twin)]
    xs = tuple(torch.as_tensor(np.asarray(a) if not isinstance(
        a, torch.Tensor) else a.detach().cpu()) for a in sample_inputs)
    xs = tuple(a.float() if a.dtype == torch.float64 else a for a in xs)
    try:
        with torch.no_grad():
            twin(*xs)
    finally:
        for h in handles:
            h.remove()
    report = CostReport()
    first = _shape(sample_inputs[0]) if sample_inputs else None
    report.batch = first[0] if first else 1
    for mod, ins, outs, params in records:
        flops = _layer_flops(mod, ins, outs, params)
        eff = flops
        if type(mod).__name__ == "BlockSparseLinear":
            eff = flops * float(mod.density())
        report.layers.append(LayerCost(
            name=getattr(mod, "name", type(mod).__name__),
            kind=type(mod).__name__, flops=flops,
            param_bytes=_param_bytes(params),
            out_elems=sum(_elems(s) for s in outs), eff_flops=eff))
    return report


def train_step_flops(model, sample_inputs, batch_size: int) -> float:
    """Training FLOPs of one global step: 3 x forward, scaled from the
    sample batch to ``batch_size`` rows."""
    rep = forward_costs(model, *sample_inputs)
    return rep.train_flops() / max(rep.batch, 1) * batch_size


def train_step_flops_detail(model, sample_inputs,
                            batch_size: int) -> Dict[str, float]:
    """Both conventions of :func:`train_step_flops`: ``dense`` (the
    ``train.flops_per_step`` / ``train.mfu`` numerator) and ``effective``
    (nonzero blocks only, the ``train.effective_mfu`` numerator)."""
    rep = forward_costs(model, *sample_inputs)
    scale = batch_size / max(rep.batch, 1)
    return {"dense": rep.train_flops() * scale,
            "effective": rep.train_eff_flops() * scale}


def mfu(flops_per_step: float, step_time_s: float, n_devices: int,
        peak: Optional[float]) -> Optional[float]:
    """Achieved FLOP/s a device over the device's peak; None without a
    peak."""
    if not peak or step_time_s <= 0 or n_devices <= 0:
        return None
    return flops_per_step / step_time_s / n_devices / peak


def collective_bytes_for_specs(params, specs, mesh,
                               dtype_bytes: int = 4) -> Dict[str, Any]:
    """Per-step, per-axis collective bytes of a declarative layout
    (``parallel.layout.collective_bytes_by_axis``): ``{"per_axis_bytes_
    per_step": ..., "param_bytes_per_chip": ...}``."""
    from bigdl_tpu_torch.parallel.layout import collective_bytes_by_axis

    return collective_bytes_by_axis(params, specs, mesh,
                                    dtype_bytes=dtype_bytes)


def embedding_lookup_bytes(batch: int, dim: int, sizes, n_tables: int = 1,
                           dtype_bytes: int = 4) -> Dict[str, Any]:
    """Per-axis collective bytes of lookups against a vocab-sharded
    table (``parallel.layout.embedding_lookup_bytes``)."""
    from bigdl_tpu_torch.parallel.layout import embedding_lookup_bytes \
        as _impl

    return _impl(batch, dim, sizes, n_tables=n_tables,
                 dtype_bytes=dtype_bytes)


def collective_ledger(step_engine) -> Dict[str, Any]:
    """Per-step collective bytes of a ``ShardedParameterStep`` (or 0s
    for a one-process ``TrainStep``), counted in the wire dtypes of its
    ``grad_comm`` / ``param_comm`` (the JAX ledger's keys)."""
    from bigdl_tpu_torch.parallel.collectives import wire_itemsize

    mode = getattr(step_engine, "grad_comm", "fp32")
    grad_ici = float(getattr(step_engine, "grad_sync_ici_bytes_per_step",
                             0))
    param_ici = float(getattr(step_engine, "param_sync_ici_bytes_per_step",
                              0))
    return {
        "ici_bytes_per_step": grad_ici + param_ici,
        "dcn_bytes_per_step": float(getattr(step_engine,
                                            "dcn_bytes_per_step", 0)),
        "grad_ici_bytes_per_step": grad_ici,
        "param_ici_bytes_per_step": param_ici,
        "n_data_replicas": float(getattr(step_engine, "n_data_replicas",
                                         1)),
        "grad_comm": mode,
        "param_comm": getattr(step_engine, "param_comm", "fp32"),
        "grad_dtype_bytes": wire_itemsize(mode),
        "comm_buckets": float(getattr(step_engine, "comm_buckets", 1)),
        "n_params_padded": float(getattr(step_engine, "n_pad", sum(
            p.numel() for p in getattr(step_engine, "params", ())))),
    }
