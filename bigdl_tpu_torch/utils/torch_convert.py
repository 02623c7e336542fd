"""Stock-torch-module conversion — the port of
``bigdl_tpu.utils.torch_convert``: a ``torch.nn.Module``'s architecture
and weights become a keras ``Model`` of the port's layers.

As in the JAX package, torch does not run on the training path: the
module's ``torch.fx`` graph is traced once on the host and each node is
re-emitted as the port's layer in a keras functional ``Model``, with the
torch weights copied in.  The result is the JAX package's conversion,
node for node: the same layers in the same order (so with the two
packages' node counters equal, the same node names), the same
channels-last layouts, and ``variables``, the ``{"params", "state"}``
tree keyed by node name that the JAX converter returns.  The trained
model takes NHWC inputs.

Conventions and limits, the JAX package's (they raise otherwise, with
the JAX messages):
- 4-D tensors are NCHW on the torch side and NHWC in the converted model;
  a Linear that reads a flattened conv map gets its weight columns
  permuted (``permute_from``).
- leaves: Conv1d/2d, ConvTranspose2d, Linear, BatchNorm1d/2d, GroupNorm,
  LayerNorm, Embedding, PReLU, activations, pooling (Max/Avg/
  AdaptiveAvg(1)), Flatten, Dropout, MultiheadAttention (batch_first),
  LSTM/GRU (batch_first; any num_layers, bidirectional, inter-layer
  dropout: a chain of recurrent layers), TransformerEncoder[Layer] (a
  structural leaf, both norm orders), Upsample.
- graph ops: +, -, *, / (tensor and scalar), cat, flatten/view(b, -1)
  with the dynamic x.size(0) / x.shape[0] forms, a spatial mean,
  ``y[:, i]``, F.interpolate (scale_factor), functional activations,
  getitem(0) of an MHA or RNN output.

Two mappings differ from the stock torch module, as the JAX converter's
do (ROADMAP C.18): ``GELU`` (erf in torch) becomes the port's tanh
``GELU``, as ``jax.nn.gelu``; and a ``MultiheadAttention``'s attention
dropout is dropped, so a converted encoder trains on the flash kernels
on the card."""

import operator
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch import nn as N
from bigdl_tpu_torch.utils.convert import load_jax_params


def _np(t):
    return np.asarray(t.detach().cpu().numpy(), np.float32)


class _ContextAttention(N.MultiHeadAttention):
    """A converted ``MultiheadAttention`` whose keys and values (one
    tensor) differ from its queries: the node's second parent is the
    context, as the JAX layer reads a second input."""

    def forward(self, x, context, key=None):
        return super().forward(x, key=key, context=context)


def _load(layer, p, s):
    """Copy a converter's params and state (numpy trees) into ``layer``."""
    if p:
        load_jax_params(layer, p)
    if s:
        load_jax_params(layer, s)
    return layer


# ---------------------------------------------------------------------------
# leaf-module converters: torch module -> (our layer, params, state)
# ---------------------------------------------------------------------------


def _conv2d(tm):
    pad = tm.padding if isinstance(tm.padding, str) else tuple(tm.padding)
    if pad == (0, 0):
        pad = 0
    layer = N.Conv2D(tm.in_channels, tm.out_channels,
                     tuple(tm.kernel_size), stride=tuple(tm.stride),
                     padding=("SAME" if pad == "same" else pad),
                     dilation=tuple(tm.dilation), groups=tm.groups,
                     with_bias=tm.bias is not None)
    p = {"weight": np.asarray(_np(tm.weight).transpose(2, 3, 1, 0))}
    if tm.bias is not None:
        p["bias"] = np.asarray(_np(tm.bias))
    return layer, p, {}


def _conv1d(tm):
    pad = tm.padding if isinstance(tm.padding, str) else tm.padding[0]
    layer = N.Conv1D(tm.in_channels, tm.out_channels, tm.kernel_size[0],
                     stride=tm.stride[0],
                     padding=("SAME" if pad == "same" else pad),
                     dilation=tm.dilation[0], groups=tm.groups,
                     with_bias=tm.bias is not None)
    p = {"weight": np.asarray(_np(tm.weight).transpose(2, 1, 0))}
    if tm.bias is not None:
        p["bias"] = np.asarray(_np(tm.bias))
    return layer, p, {}


def _convtranspose2d(tm):
    if (tuple(tm.output_padding) != (0, 0) or tuple(tm.dilation) != (1, 1)
            or tm.groups != 1):
        raise NotImplementedError(
            "ConvTranspose2d conversion supports output_padding=0, "
            "dilation=1, groups=1")
    layer = N.Conv2DTranspose(tm.in_channels, tm.out_channels,
                              tuple(tm.kernel_size), stride=tuple(tm.stride),
                              padding=tuple(tm.padding),
                              with_bias=tm.bias is not None)
    p = {"weight": np.asarray(_np(tm.weight).transpose(2, 3, 1, 0))}
    if tm.bias is not None:
        p["bias"] = np.asarray(_np(tm.bias))
    return layer, p, {}


def _linear(tm, permute_from: Optional[Tuple[int, int, int]] = None):
    layer = N.Linear(tm.in_features, tm.out_features,
                     with_bias=tm.bias is not None)
    w = _np(tm.weight)                                  # (out, in)
    if permute_from is not None:
        c, h, wd = permute_from                         # torch flatten = CHW
        w = (w.reshape(-1, c, h, wd).transpose(0, 2, 3, 1)
             .reshape(w.shape[0], -1))                  # ours = HWC
    p = {"weight": np.asarray(w.T)}
    if tm.bias is not None:
        p["bias"] = np.asarray(_np(tm.bias))
    return layer, p, {}


def _batchnorm(tm):
    if tm.momentum is None:
        raise NotImplementedError(
            "BatchNorm momentum=None (cumulative averaging) has no "
            "equivalent; set a numeric momentum")
    layer = N.BatchNorm(tm.num_features, eps=tm.eps,
                        momentum=tm.momentum,
                        affine=tm.affine)
    p = {}
    if tm.affine:
        p = {"weight": np.asarray(_np(tm.weight)),
             "bias": np.asarray(_np(tm.bias))}
    s = {"running_mean": np.asarray(_np(tm.running_mean)),
         "running_var": np.asarray(_np(tm.running_var))}
    return layer, p, s


def _layernorm(tm):
    if len(tm.normalized_shape) != 1:
        raise NotImplementedError("LayerNorm over >1 trailing dim")
    layer = N.LayerNorm(tm.normalized_shape[0], eps=tm.eps)
    return layer, {"weight": np.asarray(_np(tm.weight)),
                   "bias": np.asarray(_np(tm.bias))}, {}


def _groupnorm(tm):
    layer = N.GroupNorm(tm.num_groups, tm.num_channels, eps=tm.eps,
                        affine=tm.affine)
    p = {}
    if tm.affine:
        p = {"weight": np.asarray(_np(tm.weight)),
             "bias": np.asarray(_np(tm.bias))}
    return layer, p, {}


def _embedding(tm):
    layer = N.Embedding(tm.num_embeddings, tm.embedding_dim)
    return layer, {"weight": np.asarray(_np(tm.weight))}, {}


def _mha(tm):
    if not tm.batch_first:
        raise NotImplementedError("MultiheadAttention needs batch_first=True")
    if tm.in_proj_weight is None or tm.in_proj_bias is None:
        raise NotImplementedError(
            "MultiheadAttention conversion needs the packed in-projection "
            "with bias (bias=False and kdim/vdim variants unsupported)")
    e = tm.embed_dim
    layer = N.MultiHeadAttention(e, tm.num_heads)
    w = _np(tm.in_proj_weight)
    b = _np(tm.in_proj_bias)
    p = {"wq": np.asarray(w[:e].T), "wk": np.asarray(w[e:2 * e].T),
         "wv": np.asarray(w[2 * e:].T),
         "bq": np.asarray(b[:e]), "bk": np.asarray(b[e:2 * e]),
         "bv": np.asarray(b[2 * e:]),
         "wo": np.asarray(_np(tm.out_proj.weight).T),
         "bo": np.asarray(_np(tm.out_proj.bias))}
    return layer, p, {}


def _rnn_dir_params(tm, kind, k, suffix):
    """Params of torch layer k, one direction.  Gate orders match ours
    exactly (torch LSTM i,f,g,o; torch GRU r,z,n), and torch's GRU
    candidate form ``tanh(x_n + b_in + r*(W_hn h + b_hn))`` is precisely
    our reset-after recurrence with the ``bias_rec`` recurrent bias."""
    w_ih = _np(getattr(tm, f"weight_ih_l{k}{suffix}"))
    w_hh = _np(getattr(tm, f"weight_hh_l{k}{suffix}"))
    p = {"w_in": np.asarray(w_ih.T), "w_rec": np.asarray(w_hh.T)}
    if tm.bias:
        b_ih = _np(getattr(tm, f"bias_ih_l{k}{suffix}"))
        b_hh = _np(getattr(tm, f"bias_hh_l{k}{suffix}"))
        if kind == "GRU":
            p["bias"] = np.asarray(b_ih)
            p["bias_rec"] = np.asarray(b_hh)
        else:  # LSTM: both biases are additive outside every gate
            p["bias"] = np.asarray(b_ih + b_hh)
    else:
        p["bias"] = np.zeros((w_ih.shape[0],), np.float32)
        if kind == "GRU":
            p["bias_rec"] = np.zeros((w_ih.shape[0],), np.float32)
    return p


def _rnn_chain(tm, kind):
    """torch nn.LSTM/nn.GRU (any num_layers, optionally bidirectional) →
    list of (our_layer, params, tag) chained in sequence.  ``tag`` keys the
    export back to the torch ``weight_*_l{k}[_reverse]`` names."""
    if not tm.batch_first:
        raise NotImplementedError(f"{kind} conversion needs batch_first=True")
    cls = N.LSTM if kind == "LSTM" else N.GRU
    # torch's GRU carries b_hn inside the reset gate: the recurrent bias
    kw = {"recurrent_bias": True} if kind == "GRU" else {}
    steps = []
    for k in range(tm.num_layers):
        d_in = tm.input_size if k == 0 else \
            tm.hidden_size * (2 if tm.bidirectional else 1)
        if tm.dropout and k > 0:
            # torch applies dropout to the OUTPUT of every layer but the
            # last, i.e. before each subsequent layer's input
            steps.append((N.Dropout(tm.dropout), {}, None))
        if tm.bidirectional:
            fwd = cls(d_in, tm.hidden_size, return_sequences=True, **kw)
            bwd = cls(d_in, tm.hidden_size, return_sequences=True,
                      go_backwards=True, **kw)
            layer = N.BiRecurrent(fwd, bwd, merge="concat")
            p = {"fwd": _rnn_dir_params(tm, kind, k, ""),
                 "bwd": _rnn_dir_params(tm, kind, k, "_reverse")}
            steps.append((layer, p, f"Bi{kind}@l{k}"))
        else:
            layer = cls(d_in, tm.hidden_size, return_sequences=True, **kw)
            steps.append((layer, _rnn_dir_params(tm, kind, k, ""),
                          f"{kind}@l{k}"))
    return steps


def _prelu(tm):
    w = _np(tm.weight)
    return N.PReLU(num_features=w.shape[0]), {"alpha": w}, {}


def _upsample(tm):
    if tm.scale_factor is None:
        raise NotImplementedError("Upsample with target size (use "
                                  "scale_factor)")
    sf = tm.scale_factor
    sf = tuple(int(s) for s in sf) if isinstance(sf, (tuple, list)) \
        else (int(sf), int(sf))
    if any(float(s) != int(s) for s in (
            tm.scale_factor if isinstance(tm.scale_factor, (tuple, list))
            else [tm.scale_factor])):
        raise NotImplementedError("non-integer Upsample scale_factor")
    mode = tm.mode
    if mode == "nearest":
        return N.UpSampling2D(sf, mode="nearest"), {}, {}
    if mode == "bilinear":
        if tm.align_corners:
            raise NotImplementedError("Upsample align_corners=True "
                                      "(half-pixel centers only)")
        return N.UpSampling2D(sf, mode="bilinear"), {}, {}
    raise NotImplementedError(f"Upsample mode {mode!r}")


def _pool2d(tm, cls):
    k = tm.kernel_size if isinstance(tm.kernel_size, tuple) else \
        (tm.kernel_size, tm.kernel_size)
    s = tm.stride if isinstance(tm.stride, tuple) else \
        (tm.stride, tm.stride) if tm.stride else k
    pad = tm.padding if isinstance(tm.padding, tuple) else \
        (tm.padding, tm.padding)
    if pad == (0, 0):
        pad = 0
    return cls(k, s, padding=pad,
               ceil_mode=getattr(tm, "ceil_mode", False)), {}, {}


_SIMPLE = {
    "ReLU": lambda tm: (N.ReLU(), {}, {}),
    "ReLU6": lambda tm: (N.ReLU6(), {}, {}),
    "GELU": lambda tm: (N.GELU(), {}, {}),
    "SiLU": lambda tm: (N.SiLU(), {}, {}),
    "Sigmoid": lambda tm: (N.Sigmoid(), {}, {}),
    "Tanh": lambda tm: (N.Tanh(), {}, {}),
    "ELU": lambda tm: (N.ELU(tm.alpha), {}, {}),
    "LeakyReLU": lambda tm: (N.LeakyReLU(tm.negative_slope), {}, {}),
    "Softmax": lambda tm: (N.SoftMax(), {}, {}),
    "LogSoftmax": lambda tm: (N.LogSoftMax(), {}, {}),
    "Mish": lambda tm: (N.Mish(), {}, {}),
    "Softplus": lambda tm: (N.SoftPlus(), {}, {}),
    "Softsign": lambda tm: (N.SoftSign(), {}, {}),
    "Tanhshrink": lambda tm: (N.TanhShrink(), {}, {}),
    "Softshrink": lambda tm: (N.SoftShrink(tm.lambd), {}, {}),
    "Hardshrink": lambda tm: (N.HardShrink(tm.lambd), {}, {}),
    "LogSigmoid": lambda tm: (N.LogSigmoid(), {}, {}),
    "Hardswish": lambda tm: (N.HardSwish(), {}, {}),
    "Hardsigmoid": lambda tm: (N.HardSigmoid(), {}, {}),
    "Hardtanh": lambda tm: (N.HardTanh(tm.min_val, tm.max_val), {}, {}),
    "Identity": lambda tm: (N.Identity(), {}, {}),
    "Dropout": lambda tm: (N.Dropout(tm.p), {}, {}),
    "Flatten": lambda tm: (N.Flatten(), {}, {}),
    "Linear": _linear,
    "Conv2d": _conv2d,
    "Conv1d": _conv1d,
    "ConvTranspose2d": _convtranspose2d,
    "BatchNorm1d": _batchnorm,
    "BatchNorm2d": _batchnorm,
    "GroupNorm": _groupnorm,
    "LayerNorm": _layernorm,
    "Embedding": _embedding,
    "PReLU": _prelu,
    "MultiheadAttention": _mha,
    "Upsample": _upsample,
    "UpsamplingNearest2d": _upsample,
    "UpsamplingBilinear2d": _upsample,
    "MaxPool2d": lambda tm: _pool2d(tm, N.MaxPool2D),
    "AvgPool2d": lambda tm: _pool2d(tm, N.AvgPool2D),
}


class _ConvertTracer:
    """fx tracer whose leaves are exactly the convertible torch modules —
    containers and custom modules are traced through."""

    def build(self, tmodule):
        import torch.fx as fx

        leaf_names = set(_SIMPLE) | {"AdaptiveAvgPool2d", "LSTM", "GRU",
                             "TransformerEncoder",
                             "TransformerEncoderLayer"}

        class T(fx.Tracer):
            def is_leaf_module(self, m, qualname):
                return type(m).__name__ in leaf_names

        tracer = T()
        graph = tracer.trace(tmodule)
        gm = fx.GraphModule(tracer.root, graph)
        # `a, _ = mha(...)`-style unpacks leave dead getitem nodes behind
        gm.graph.eliminate_dead_code()
        gm.recompile()
        return gm


def _meta_shape(node):
    tm = node.meta.get("tensor_meta")
    return tuple(tm.shape) if tm is not None and hasattr(tm, "shape") else None


def from_torch_module(tmodule, example_input=None):
    """torch.nn.Module → (keras-engine Model, variables) with weights.

    ``example_input``: numpy array (or tuple of arrays for multi-input
    modules) in TORCH layout (e.g. NCHW), used for shape propagation —
    required when the graph flattens conv maps into Linear layers (the
    weight-permutation fixup needs shapes) or concatenates on mapped
    axes."""
    tmodule = tmodule.eval()
    # fx always traces the ROOT's forward, so a module that must convert
    # as a leaf (RNNs, TransformerEncoder[Layer], MHA — their forwards
    # break under symbolic trace) gets a trivial wrapper root; export
    # quals drop the wrapper prefix again below
    _LEAF_ROOTS = {"LSTM", "GRU", "TransformerEncoder",
                   "TransformerEncoderLayer", "MultiheadAttention"}
    wrapped = type(tmodule).__name__ in _LEAF_ROOTS
    if wrapped:
        class _Root(torch.nn.Module):
            def __init__(self, m):
                super().__init__()
                self.mod = m

            def forward(self, x):
                return self.mod(x)

        tmodule = _Root(tmodule)
    gm = _ConvertTracer().build(tmodule)
    if example_input is not None:
        from torch.fx.passes.shape_prop import ShapeProp

        ex = (example_input if isinstance(example_input, (tuple, list))
              else (example_input,))
        ShapeProp(gm).propagate(
            *(torch.tensor(np.asarray(e)) for e in ex))

    from bigdl_tpu_torch.keras.engine import Input, Model
    from bigdl_tpu_torch.keras.layers import Merge

    sym: Dict[Any, Any] = {}        # fx node -> keras node
    params: Dict[str, Dict] = {}
    state: Dict[str, Dict] = {}
    pre_flatten: Dict[Any, Tuple[int, int, int]] = {}  # flatten out -> CHW
    flat_already: set = set()       # nodes whose output is already (b, c)
    inputs = []
    outputs = []
    # (keras node name, torch qualname, torch type, linear permute_from) —
    # consumed by export_state_dict for the round trip back to torch
    export_map = []

    def emit(fx_node, layer, parents, p=None, s=None):
        _load(layer, p, s)
        kn = layer(parents[0] if len(parents) == 1 else list(parents))
        sym[fx_node] = kn
        if p:
            params[kn.name] = p
        if s:
            state[kn.name] = s
        return kn

    def to_nhwc_shape(shape):
        if shape is None:
            return None
        if len(shape) == 4:
            return (shape[2], shape[3], shape[1])
        return tuple(shape[1:])

    def conv_axis(fx_node, dim):
        """torch dim on an NCHW tensor -> our NHWC axis."""
        shape = _meta_shape(fx_node)
        if shape is None:
            raise ValueError(
                "axis-mapped op on an unknown-shape tensor: pass "
                "example_input so shapes can be propagated (a torch dim on "
                "a 4-D NCHW tensor maps to a different NHWC axis)")
        if len(shape) == 4:
            table = {0: 0, 1: -1, 2: 1, 3: 2, -1: 2, -2: 1, -3: -1, -4: 0}
            if dim not in table:
                raise NotImplementedError(f"axis {dim} on a 4-D tensor")
            return table[dim]
        return dim

    def is_flatten_to_vec(node):
        """view/reshape/flatten collapsing everything AFTER the batch dim
        (start_dim=1, end_dim=-1).  Other start/end dims fall through to
        the generic unsupported-node error — a partial flatten is not a
        batch-preserving vectorization."""
        if ((node.op == "call_function" and node.target is torch.flatten)
                or (node.op == "call_method"
                    and node.target == "flatten")):
            start = (node.args[1] if len(node.args) > 1
                     else node.kwargs.get("start_dim", 0))
            end = (node.args[2] if len(node.args) > 2
                   else node.kwargs.get("end_dim", -1))
            return start == 1 and end == -1
        if node.op == "call_method" and node.target in ("view", "reshape"):
            if len(node.args) != 3 or node.args[2] != -1:
                return False
            # x.view(n, -1) is only a batch-preserving flatten when n IS the
            # batch size; x.view(6, -1) on a (2,3,4,5) tensor would otherwise
            # convert to Flatten() and be silently wrong
            first = node.args[1]
            if isinstance(first, torch.fx.Node):
                # dynamic batch: y.view(x.size(0), -1) traces args[1] as a
                # size(0)-of-some-node (or shape[0] getitem); accept when
                # that node's batch dim provably equals the view source's
                src = node.args[0]
                size_src = None
                if (first.op == "call_method" and first.target == "size"
                        and len(first.args) == 2 and first.args[1] == 0):
                    size_src = first.args[0]
                elif (first.op == "call_function"
                        and first.target is operator.getitem
                        and len(first.args) == 2 and first.args[1] == 0
                        and isinstance(first.args[0], torch.fx.Node)
                        and first.args[0].op == "call_function"
                        and first.args[0].target is getattr
                        and first.args[0].args[1:] == ("shape",)):
                    size_src = first.args[0].args[0]
                if size_src is None:
                    return False
                if size_src is src:
                    return True
                ss, vs = _meta_shape(size_src), _meta_shape(src)
                return ss is not None and vs is not None and ss[0] == vs[0]
            src_shape = _meta_shape(node.args[0])
            # without shape metadata the batch-dim check cannot run — fall
            # through to the unsupported-node error (pass example_input)
            return src_shape is not None and first == src_shape[0]
        return False

    def _consumed_by_flatten(node):
        """Scalar side nodes (size/shape/getitem) are skippable when every
        consumer is an accepted batch-preserving flatten (possibly through
        another scalar side node, e.g. getattr-shape → getitem → view)."""
        users = list(node.users)
        return bool(users) and all(
            is_flatten_to_vec(u) or _consumed_by_flatten(u) for u in users)

    def handle_flatten(node, src):
        if src in flat_already:     # AdaptiveAvgPool2d(1) already emitted (b,c)
            sym[node] = sym[src]
            return
        shape = _meta_shape(src)
        if shape is not None and len(shape) == 4:
            pre = (shape[1], shape[2], shape[3])
            kn = emit(node, N.Flatten(), [sym[src]])
            pre_flatten[node] = pre
        elif shape is None:
            raise ValueError(
                "flatten of an unknown-shape tensor: pass example_input so "
                "shapes can be propagated (needed for the NCHW->NHWC Linear "
                "weight fixup)")
        else:
            emit(node, N.Flatten(), [sym[src]])

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            shape = _meta_shape(node)
            kn = Input(to_nhwc_shape(shape))
            sym[node] = kn
            inputs.append(kn)

        elif node.op == "call_module":
            tm = gm.get_submodule(node.target)
            tname = type(tm).__name__
            src_nodes = [a for a in node.args
                         if isinstance(a, torch.fx.Node)]
            if tname == "AdaptiveAvgPool2d":
                out = tm.output_size
                out = out if isinstance(out, tuple) else (out, out)
                if out not in ((1, 1), (1,)):
                    raise NotImplementedError(
                        "AdaptiveAvgPool2d only supported with output 1")
                emit(node, N.GlobalAvgPool2D(), [sym[src_nodes[0]]])
                flat_already.add(node)
                continue
            if tname in ("LSTM", "GRU"):
                kn = sym[src_nodes[0]]
                for layer, p, tag in _rnn_chain(tm, tname):
                    kn = _load(layer, p, None)(kn)
                    if p:
                        params[kn.name] = p
                        export_map.append((kn.name, node.target, tag, None))
                sym[node] = kn
                continue
            if tname in ("TransformerEncoder", "TransformerEncoderLayer"):
                # torch's forward has mask-canonicalization that breaks fx
                # tracing, so the layer is a LEAF converted structurally:
                # its anatomy (self_attn/linear1/linear2/norm1/norm2,
                # norm_first) is fixed by torch
                def put(kn2, layer, p, qual2, sub_tname):
                    kn2 = _load(layer, p, None)(kn2)
                    if p:
                        params[kn2.name] = p
                        export_map.append((kn2.name, qual2, sub_tname, None))
                    return kn2

                def one_block(tl, kn_in, qual2):
                    if tl.self_attn.batch_first is False:
                        raise NotImplementedError(
                            "TransformerEncoderLayer needs batch_first=True")
                    act = {torch.nn.functional.relu: N.ReLU,
                           torch.nn.functional.gelu: N.GELU}.get(
                        tl.activation)
                    if act is None:
                        raise NotImplementedError(
                            f"encoder activation {tl.activation}")
                    mha_l, mha_p, _ = _mha(tl.self_attn)

                    def attn_part(kn_x):
                        a = put(kn_x, mha_l, mha_p,
                                f"{qual2}.self_attn", "MultiheadAttention")
                        if tl.dropout1.p:
                            a = N.Dropout(tl.dropout1.p)(a)
                        return a

                    def ff_part(kn_x):
                        l1, p1, _ = _linear(tl.linear1)
                        h = put(kn_x, l1, p1, f"{qual2}.linear1", "Linear")
                        h = act()(h)
                        if tl.dropout.p:
                            h = N.Dropout(tl.dropout.p)(h)
                        l2, p2, _ = _linear(tl.linear2)
                        h = put(h, l2, p2, f"{qual2}.linear2", "Linear")
                        if tl.dropout2.p:
                            h = N.Dropout(tl.dropout2.p)(h)
                        return h

                    def norm(kn_x, tn, name):
                        nl, np_, _ = _layernorm(tn)
                        return put(kn_x, nl, np_, f"{qual2}.{name}",
                                   "LayerNorm")

                    if tl.norm_first:
                        a = attn_part(norm(kn_in, tl.norm1, "norm1"))
                        x1 = N.CAddTable()([kn_in, a])
                        f = ff_part(norm(x1, tl.norm2, "norm2"))
                        return N.CAddTable()([x1, f])
                    a = attn_part(kn_in)
                    x1 = norm(N.CAddTable()([kn_in, a]), tl.norm1, "norm1")
                    f = ff_part(x1)
                    return norm(N.CAddTable()([x1, f]), tl.norm2, "norm2")

                kn = sym[src_nodes[0]]
                if tname == "TransformerEncoder":
                    for li, tl in enumerate(tm.layers):
                        kn = one_block(tl, kn,
                                       f"{node.target}.layers.{li}")
                    if tm.norm is not None:
                        nl, np_, _ = _layernorm(tm.norm)
                        kn = put(kn, nl, np_, f"{node.target}.norm",
                                 "LayerNorm")
                else:
                    kn = one_block(tm, kn, node.target)
                sym[node] = kn
                continue
            if tname not in _SIMPLE:
                raise NotImplementedError(
                    f"no conversion for torch module {tname} "
                    f"(at graph node {node.name})")
            conv = _SIMPLE[tname]
            # elementwise layers preserve the flattened HWC element order,
            # so a pending Linear weight-permutation marker flows through
            # (classifier heads commonly interleave Dropout/ReLU between
            # flatten and fc)
            _PASSTHROUGH = ("Dropout", "ReLU", "ReLU6", "GELU", "SiLU",
                            "Sigmoid", "Tanh", "ELU", "LeakyReLU",
                            "Hardtanh", "Identity", "PReLU")
            if tname in _PASSTHROUGH and src_nodes \
                    and src_nodes[0] in pre_flatten:
                pre_flatten[node] = pre_flatten[src_nodes[0]]
            permute_from = None
            if tname == "Linear":
                src = src_nodes[0]
                permute_from = pre_flatten.get(src)
                layer, p, s = conv(tm, permute_from)
            elif tname == "MultiheadAttention":
                q, k, v = node.args[0], node.args[1], node.args[2]
                layer, p, s = conv(tm)
                if q is k and k is v:
                    parents = [sym[q]]
                elif k is v:
                    layer = _ContextAttention(tm.embed_dim, tm.num_heads,
                                              name="MultiHeadAttention")
                    parents = [sym[q], sym[k]]
                else:
                    raise NotImplementedError(
                        "MultiheadAttention with distinct k and v")
                kn = emit(node, layer, parents, p, s)
                export_map.append((kn.name, node.target, tname, None))
                continue
            else:
                layer, p, s = conv(tm)
            kn = emit(node, layer, [sym[src_nodes[0]]], p, s)
            if p or s:
                export_map.append((kn.name, node.target, tname, permute_from))

        elif node.op == "call_function":
            fn = node.target
            if (fn is getattr or fn is operator.getitem) \
                    and _consumed_by_flatten(node):
                pass  # x.shape[0] chain feeding an accepted flatten
            elif fn in (operator.add, torch.add, operator.sub, torch.sub,
                      operator.mul, torch.mul, operator.truediv,
                      torch.div):
                a, b = node.args[0], node.args[1]
                a_t = isinstance(a, torch.fx.Node)
                b_t = isinstance(b, torch.fx.Node)
                sub = fn in (operator.sub, torch.sub)
                div = fn in (operator.truediv, torch.div)
                mul = fn in (operator.mul, torch.mul)
                if a_t and b_t:
                    if sub:
                        emit(node, N.CSubTable(), [sym[a], sym[b]])
                    elif div:
                        emit(node, N.CDivTable(), [sym[a], sym[b]])
                    else:
                        emit(node, Merge("mul" if mul else "sum"),
                             [sym[a], sym[b]])
                elif a_t and isinstance(b, (int, float)):
                    # scalar arithmetic (x/255.0-style normalization)
                    if mul:
                        lay = N.MulConstant(float(b))
                    elif div:
                        lay = N.MulConstant(1.0 / float(b))
                    else:
                        lay = N.AddConstant(float(-b if sub else b))
                    if a in pre_flatten:   # elementwise: marker flows on
                        pre_flatten[node] = pre_flatten[a]
                    emit(node, lay, [sym[a]])
                else:
                    raise NotImplementedError(
                        f"{fn} with operands ({type(a).__name__}, "
                        f"{type(b).__name__}) at node {node.name}")
            elif fn is torch.cat:
                tensors = node.args[0]
                dim = node.args[1] if len(node.args) > 1 else \
                    node.kwargs.get("dim", 0)
                axis = conv_axis(tensors[0], dim)
                emit(node, Merge("concat", concat_axis=axis),
                     [sym[t] for t in tensors])
            elif fn is operator.getitem:
                src = node.args[0]
                tm_name = (type(gm.get_submodule(src.target)).__name__
                           if src.op == "call_module" else "")
                idx = node.args[1]
                if idx == 0 and tm_name in ("LSTM", "GRU",
                                            "MultiheadAttention"):
                    sym[node] = sym[src]   # our layer returns the seq output
                elif (isinstance(idx, tuple) and len(idx) == 2
                        and idx[0] == slice(None)
                        and isinstance(idx[1], int)):
                    # y[:, i] — timestep select (e.g. last RNN output)
                    emit(node, N.Select(1, idx[1]), [sym[src]])
                else:
                    raise NotImplementedError(
                        f"getitem[{idx}] on {src}")
            elif is_flatten_to_vec(node):
                handle_flatten(node, node.args[0])
            elif fn in (torch.relu, torch.nn.functional.relu):
                if node.args[0] in pre_flatten:
                    pre_flatten[node] = pre_flatten[node.args[0]]
                emit(node, N.ReLU(), [sym[node.args[0]]])
            elif fn is torch.nn.functional.interpolate:
                sf = node.kwargs.get("scale_factor") or (
                    node.args[2] if len(node.args) > 2 else None)
                mode = node.kwargs.get("mode", "nearest")
                if sf is None:
                    raise NotImplementedError(
                        "F.interpolate with target size (use scale_factor)")
                sfp = tuple(int(s) for s in sf) if isinstance(
                    sf, (tuple, list)) else (int(sf), int(sf))
                if mode not in ("nearest", "bilinear") or (
                        mode == "bilinear"
                        and node.kwargs.get("align_corners")):
                    raise NotImplementedError(
                        f"F.interpolate mode {mode!r}/align_corners")
                emit(node, N.UpSampling2D(sfp, mode=mode),
                     [sym[node.args[0]]])
            elif fn in (torch.nn.functional.silu,):
                emit(node, N.SiLU(), [sym[node.args[0]]])
            elif fn is torch.nn.functional.leaky_relu:
                slope = (node.args[1] if len(node.args) > 1
                         else node.kwargs.get("negative_slope", 0.01))
                emit(node, N.LeakyReLU(float(slope)), [sym[node.args[0]]])
            elif fn in (torch.nn.functional.elu,):
                alpha = (node.args[1] if len(node.args) > 1
                         else node.kwargs.get("alpha", 1.0))
                emit(node, N.ELU(float(alpha)), [sym[node.args[0]]])
            elif fn is torch.nn.functional.log_softmax:
                emit(node, N.LogSoftMax(), [sym[node.args[0]]])
            elif fn in (torch.nn.functional.hardswish,):
                emit(node, N.HardSwish(), [sym[node.args[0]]])
            elif fn in (torch.nn.functional.softplus,):
                emit(node, N.SoftPlus(), [sym[node.args[0]]])
            elif fn is torch.nn.functional.gelu:
                emit(node, N.GELU(), [sym[node.args[0]]])
            elif fn in (torch.sigmoid, torch.nn.functional.sigmoid):
                emit(node, N.Sigmoid(), [sym[node.args[0]]])
            elif fn in (torch.tanh, torch.nn.functional.tanh):
                emit(node, N.Tanh(), [sym[node.args[0]]])
            elif fn is torch.nn.functional.softmax:
                emit(node, N.SoftMax(), [sym[node.args[0]]])
            elif fn is torch.nn.functional.dropout:
                if node.args[0] in pre_flatten:
                    pre_flatten[node] = pre_flatten[node.args[0]]
                p = node.args[1] if len(node.args) > 1 else \
                    node.kwargs.get("p", 0.5)
                emit(node, N.Dropout(p), [sym[node.args[0]]])
            else:
                raise NotImplementedError(
                    f"no conversion for function {fn} "
                    f"(at graph node {node.name})")

        elif node.op == "call_method":
            if is_flatten_to_vec(node):
                handle_flatten(node, node.args[0])
            elif node.target == "size" and _consumed_by_flatten(node):
                # x.size(0) consumed only by accepted batch-preserving
                # flattens (the x.view(x.size(0), -1) idiom) — scalar side
                # value, nothing to emit
                pass
            elif node.target == "contiguous":
                sym[node] = sym[node.args[0]]
            elif node.target == "mean":
                src = node.args[0]
                dims = node.args[1] if len(node.args) > 1 else \
                    node.kwargs.get("dim")
                shape = _meta_shape(src)
                dim_list = ([dims] if isinstance(dims, int)
                            else list(dims or ()))
                if shape and len(shape) == 4 and tuple(sorted(
                        d % 4 for d in dim_list)) == (2, 3):
                    emit(node, N.GlobalAvgPool2D(), [sym[src]])
                    flat_already.add(node)
                elif shape and len(shape) == 3 and len(dim_list) == 1:
                    # sequence pooling (b, t, d): same axis both layouts
                    emit(node, N.Mean(dim=dim_list[0] % 3), [sym[src]])
                else:
                    raise NotImplementedError(
                        f"mean over dims {dims} (spatial NCHW mean or one "
                        "axis of a 3-D tensor)")
            else:
                raise NotImplementedError(
                    f"no conversion for method .{node.target}() "
                    f"(at graph node {node.name})")

        elif node.op == "output":
            args = node.args[0]
            outs = args if isinstance(args, (tuple, list)) else [args]
            outputs = [sym[o] for o in outs]

        elif node.op == "get_attr":
            raise NotImplementedError(
                f"free tensor attribute {node.target} in the graph")

    if wrapped:  # strip the wrapper prefix from export quals
        def _strip(q):
            return q[4:] if q.startswith("mod.") else ("" if q == "mod" else q)

        export_map = [(n, _strip(q), t, pf) for n, q, t, pf in export_map]
    model = Model(inputs, outputs, name="TorchConverted")
    model._torch_export_map = export_map
    return model, {"params": params, "state": state}


def export_state_dict(model, variables) -> Dict[str, Any]:
    """Inverse of the conversion: trained variables → a torch
    ``state_dict``-shaped dict of torch tensors keyed by the ORIGINAL
    module's parameter names (``<qualname>.weight`` etc.), ready for
    ``tmodule.load_state_dict``.  RNN recurrent biases come back fused
    into ``bias_ih_l0`` (``bias_hh_l0`` zeros) — mathematically the same
    cell."""
    emap = getattr(model, "_torch_export_map", None)
    if emap is None:
        raise ValueError("model was not produced by from_torch_module")
    params = variables.get("params", {})
    state = variables.get("state", {})
    out: Dict[str, Any] = {}

    def t(a):
        if isinstance(a, torch.Tensor):
            return a.detach().float().cpu().clone()
        return torch.tensor(np.asarray(a))

    def a_(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)

    for kname, qual, tname, permute_from in emap:
        p = params.get(kname, {})
        s = state.get(kname, {})
        if tname == "Linear":
            w = a_(p["weight"]).T          # (out, in_hwc)
            if permute_from is not None:
                c, h, wd = permute_from
                w = (w.reshape(-1, h, wd, c).transpose(0, 3, 1, 2)
                     .reshape(w.shape[0], -1))
            out[f"{qual}.weight"] = t(w)
            if "bias" in p:
                out[f"{qual}.bias"] = t(p["bias"])
        elif tname == "Conv2d":
            out[f"{qual}.weight"] = t(
                a_(p["weight"]).transpose(3, 2, 0, 1))
            if "bias" in p:
                out[f"{qual}.bias"] = t(p["bias"])
        elif tname == "Conv1d":
            out[f"{qual}.weight"] = t(
                a_(p["weight"]).transpose(2, 1, 0))
            if "bias" in p:
                out[f"{qual}.bias"] = t(p["bias"])
        elif tname == "ConvTranspose2d":
            out[f"{qual}.weight"] = t(
                a_(p["weight"]).transpose(3, 2, 0, 1))
            if "bias" in p:
                out[f"{qual}.bias"] = t(p["bias"])
        elif tname in ("BatchNorm1d", "BatchNorm2d"):
            if "weight" in p:
                out[f"{qual}.weight"] = t(p["weight"])
                out[f"{qual}.bias"] = t(p["bias"])
            out[f"{qual}.running_mean"] = t(s["running_mean"])
            out[f"{qual}.running_var"] = t(s["running_var"])
        elif tname in ("LayerNorm", "GroupNorm"):
            if "weight" in p:
                out[f"{qual}.weight"] = t(p["weight"])
                out[f"{qual}.bias"] = t(p["bias"])
        elif tname == "Embedding":
            out[f"{qual}.weight"] = t(p["weight"])
        elif tname == "PReLU":
            out[f"{qual}.weight"] = t(p["alpha"])
        elif tname == "MultiheadAttention":
            w = np.concatenate([a_(p["wq"]).T, a_(p["wk"]).T,
                                a_(p["wv"]).T], 0)
            b = np.concatenate([a_(p["bq"]), a_(p["bk"]),
                                a_(p["bv"])], 0)
            out[f"{qual}.in_proj_weight"] = t(w)
            out[f"{qual}.in_proj_bias"] = t(b)
            out[f"{qual}.out_proj.weight"] = t(a_(p["wo"]).T)
            out[f"{qual}.out_proj.bias"] = t(p["bo"])
        elif "@l" in tname and tname.split("@")[0].lstrip("Bi") in (
                "LSTM", "GRU"):
            base, lk = tname.split("@l")
            kind = base.lstrip("Bi")

            def put(dp, suffix, lk=lk, kind=kind):
                out[f"{qual}.weight_ih_l{lk}{suffix}"] = t(
                    a_(dp["w_in"]).T)
                out[f"{qual}.weight_hh_l{lk}{suffix}"] = t(
                    a_(dp["w_rec"]).T)
                if kind == "GRU":
                    out[f"{qual}.bias_ih_l{lk}{suffix}"] = t(dp["bias"])
                    out[f"{qual}.bias_hh_l{lk}{suffix}"] = t(dp["bias_rec"])
                else:
                    out[f"{qual}.bias_ih_l{lk}{suffix}"] = t(dp["bias"])
                    out[f"{qual}.bias_hh_l{lk}{suffix}"] = \
                        torch.zeros_like(t(dp["bias"]))

            if base.startswith("Bi"):
                put(p["fwd"], "")
                put(p["bwd"], "_reverse")
            else:
                put(p, "")
        else:  # pragma: no cover — emitters above cover every param leaf
            raise NotImplementedError(f"export for {tname}")
    return out


# ---------------------------------------------------------------------------
# loss / optimizer mapping
# ---------------------------------------------------------------------------


def convert_torch_loss(tloss):
    """Map a torch loss instance to the equivalent criterion."""
    from bigdl_tpu_torch.nn.criterion import Criterion

    if isinstance(tloss, Criterion):
        return tloss
    mapping = {
        "CrossEntropyLoss": N.CrossEntropyCriterion,
        "MSELoss": N.MSECriterion,
        "L1Loss": N.AbsCriterion,
        "NLLLoss": N.ClassNLLCriterion,
        "BCELoss": N.BCECriterion,
        "BCEWithLogitsLoss": N.BCEWithLogitsCriterion,
        "SmoothL1Loss": N.SmoothL1Criterion,
    }
    tname = type(tloss).__name__
    if tname not in mapping:
        raise NotImplementedError(f"no criterion mapping for torch {tname}")
    return mapping[tname]()


def convert_torch_optimizer(topt):
    """Map a torch.optim.Optimizer instance (its hyperparameters — the
    state is per-parameter torch tensors and starts fresh) to an
    OptimMethod."""
    from bigdl_tpu_torch.optim.optim_method import (SGD, Adam,
                                                    AdamWeightDecay,
                                                    OptimMethod, RMSprop)

    if isinstance(topt, OptimMethod):
        return topt
    if len(topt.param_groups) > 1:
        raise NotImplementedError(
            "multi-param-group torch optimizers (per-group lr/wd) have no "
            "flat-parameter OptimMethod mapping — pass a native OptimMethod "
            "instead")
    g = topt.param_groups[0]
    tname = type(topt).__name__
    if tname == "SGD":
        return SGD(learning_rate=g["lr"], momentum=g.get("momentum", 0.0),
                   weight_decay=g.get("weight_decay", 0.0),
                   nesterov=g.get("nesterov", False))
    if tname == "Adam":
        b1, b2 = g.get("betas", (0.9, 0.999))
        return Adam(learning_rate=g["lr"], beta1=b1, beta2=b2,
                    epsilon=g.get("eps", 1e-8))
    if tname == "AdamW":
        b1, b2 = g.get("betas", (0.9, 0.999))
        return AdamWeightDecay(learning_rate=g["lr"], beta1=b1, beta2=b2,
                               weight_decay=g.get("weight_decay", 1e-2))
    if tname == "RMSprop":
        return RMSprop(learning_rate=g["lr"],
                       decay_rate=g.get("alpha", 0.99),
                       epsilon=g.get("eps", 1e-8))
    raise NotImplementedError(f"no OptimMethod mapping for torch {tname}")
