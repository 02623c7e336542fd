"""The port's stock-torch conversion (``bigdl_tpu_torch.utils.
torch_convert``) against the JAX package's (``bigdl_tpu.utils.
torch_convert``), and the converter's thirteen new leaves.

Every module of ``tests/test_from_torch.py`` is converted by both
packages with their node counters set equal, so the two graphs' node
names agree: the parameter and state trees are equal by name, shape and
bits, the export maps equal, the forwards within 1e-5 of the largest
|value| (at least 1), and ``export_state_dict`` gives the same keys and
the same bits, which a fresh torch module loads with ``strict=True``.
The refusals raise the same errors, and the loss and optimizer mappings
land on the port's counterparts of the JAX classes.  The converted
models follow JAX, not torch (ROADMAP C.18: the tanh GELU), so the stock
module is held only as the JAX tests hold it."""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import bigdl_tpu.keras.engine as jengine
import bigdl_tpu.nn as jnn
import bigdl_tpu_torch.keras.engine as pengine
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu.utils import torch_convert as J
from bigdl_tpu_torch.utils import torch_convert as P
from test_from_torch import (SmallCNN, TinyBert, _InvertedResidual,
                             _ResNet18)

TOL = 1e-5
RS = np.random.RandomState(0)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _both(tm, example):
    """(JAX model, variables), (port model, variables) of ``tm``, the
    node counters equal before each conversion."""
    start = max(jengine._node_counter[0], pengine._node_counter[0]) + 1000
    jengine._node_counter[0] = start
    j = J.from_torch_module(tm, example_input=example)
    pengine._node_counter[0] = start
    p = P.from_torch_module(tm, example_input=example)
    return j, p


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _bit_equal_trees(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype, k
        assert x.tobytes() == y.tobytes(), k


# ---- the modules of tests/test_from_torch.py (and their in-test nets) ------


class DropoutFlatten(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(2, 3, 3, padding=1)
        self.drop = torch.nn.Dropout(0.5)
        self.fc = torch.nn.Linear(3 * 4 * 4, 5)

    def forward(self, x):
        y = torch.flatten(torch.relu(self.conv(x)), 1)
        return self.fc(self.drop(y))


class Scalars(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 4)

    def forward(self, x):
        y = x / 2.0 - 0.5
        z = self.fc(y)
        w = z - y
        return w * 3.0 + (z / (y + 2.0))


class TwoTower(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(4, 8)
        self.b = torch.nn.Linear(6, 8)
        self.head = torch.nn.Linear(16, 2)

    def forward(self, u, v):
        return self.head(torch.cat([torch.relu(self.a(u)),
                                    torch.relu(self.b(v))], dim=1))


class View(torch.nn.Module):
    def __init__(self, how):
        super().__init__()
        self.how = how
        self.fc = torch.nn.Linear(60, 2)

    def forward(self, x):
        if self.how == "batch":
            return self.fc(x.view(2, -1))
        if self.how == "size":
            return self.fc(x.view(x.size(0), -1))
        return self.fc(x.reshape(x.shape[0], -1))


class RNN(torch.nn.Module):
    def __init__(self, kind, layers, bidi):
        super().__init__()
        self.rnn = kind(5, 6, num_layers=layers, bidirectional=bidi,
                        batch_first=True, dropout=0.2 if layers > 1 else 0)
        self.fc = torch.nn.Linear(6 * (2 if bidi else 1), 3)

    def forward(self, x):
        y, _ = self.rnn(x)
        return self.fc(y[:, -1])


class MiniMobileNet(torch.nn.Module):
    def __init__(self, classes=5):
        super().__init__()
        self.stem = torch.nn.Sequential(
            torch.nn.Conv2d(3, 8, 3, 2, 1, bias=False),
            torch.nn.BatchNorm2d(8), torch.nn.Hardswish())
        self.blocks = torch.nn.Sequential(
            _InvertedResidual(8, 8, 1, 1), _InvertedResidual(8, 12, 2, 4),
            _InvertedResidual(12, 12, 1, 4))
        self.pool = torch.nn.AdaptiveAvgPool2d(1)
        self.fc = torch.nn.Linear(12, classes)

    def forward(self, x):
        return self.fc(torch.flatten(self.pool(self.blocks(self.stem(x))),
                                     1))


class MiniUNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.down = torch.nn.Conv2d(3, 6, 3, 2, 1)
        self.mid = torch.nn.Conv2d(6, 6, 3, 1, 1)
        self.up = torch.nn.Upsample(scale_factor=2, mode="nearest")
        self.out = torch.nn.Conv2d(9, 2, 1)

    def forward(self, x):
        d = torch.relu(self.down(x))
        u = self.up(torch.relu(self.mid(d)))
        return self.out(torch.cat([u, x], dim=1))


class Wrap(torch.nn.Module):
    def __init__(self, mod):
        super().__init__()
        self.mod = mod

    def forward(self, x):
        return self.mod(x)


class Func(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fc = torch.nn.Linear(6, 6)
        self.fn = fn

    def forward(self, z):
        return self.fn(self.fc(z))


class Act(torch.nn.Module):
    def __init__(self, act):
        super().__init__()
        self.fc = torch.nn.Linear(6, 6)
        self.act = act

    def forward(self, x):
        return self.act(self.fc(x))


class BertClf(torch.nn.Module):
    def __init__(self, vocab=40, d=16):
        super().__init__()
        self.emb = torch.nn.Embedding(vocab, d)
        self.enc = torch.nn.TransformerEncoder(
            torch.nn.TransformerEncoderLayer(d, 2, 32, batch_first=True,
                                             dropout=0.0), 1)
        self.cls = torch.nn.Linear(d, 2)

    def forward(self, ids):
        return self.cls(self.enc(self.emb(ids)).mean(dim=[1]))


class CrossAttention(torch.nn.Module):
    """Queries from one tensor, keys and values (one tensor) from
    another: the JAX converter's two-parent attention."""

    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(8, 8)
        self.mha = torch.nn.MultiheadAttention(8, 2, batch_first=True)

    def forward(self, x):
        m = torch.tanh(self.a(x))
        out, _ = self.mha(x, m, m)
        return out


class GroupNormNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.gn = torch.nn.GroupNorm(2, 8)
        self.up = torch.nn.ConvTranspose2d(8, 4, 3, stride=2, padding=1)

    def forward(self, x):
        return self.up(self.gn(self.conv(x)))


class _Interp(torch.nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode="nearest")


def _encoder(norm_first):
    return torch.nn.TransformerEncoder(
        torch.nn.TransformerEncoderLayer(
            16, 2, 32, batch_first=True, dropout=0.0, activation="gelu",
            norm_first=norm_first), num_layers=2)


def _img(*shape):
    return RS.rand(*shape).astype(np.float32)


CASES = {
    "small_cnn": (lambda: SmallCNN(), lambda: _img(4, 3, 8, 8)),
    "tiny_bert": (lambda: TinyBert(),
                  lambda: RS.randint(0, 32, (3, 7)).astype(np.int64)),
    "resnet18": (lambda: _ResNet18(classes=10, width=8),
                 lambda: _img(2, 3, 32, 32)),
    "mobilenet_v2": (MiniMobileNet, lambda: _img(2, 3, 32, 32)),
    "unet": (MiniUNet, lambda: _img(2, 3, 8, 8)),
    "upsample_bilinear": (lambda: Wrap(torch.nn.Upsample(
        scale_factor=2, mode="bilinear", align_corners=False)),
        lambda: _img(2, 3, 8, 8)),
    "interpolate": (_Interp, lambda: _img(2, 3, 4, 4)),
    "encoder_post_norm": (lambda: _encoder(False), lambda: _img(2, 5, 16)),
    "encoder_pre_norm": (lambda: _encoder(True), lambda: _img(2, 5, 16)),
    "encoder_layer": (lambda: torch.nn.TransformerEncoderLayer(
        16, 2, 32, batch_first=True, dropout=0.1), lambda: _img(2, 5, 16)),
    "bert_classifier": (BertClf,
                        lambda: RS.randint(0, 40, (3, 6)).astype(np.int64)),
    "cross_attention": (CrossAttention, lambda: _img(2, 5, 8)),
    "dropout_flatten": (DropoutFlatten, lambda: _img(2, 2, 4, 4)),
    "scalars": (Scalars, lambda: _img(3, 4) + 0.5),
    "two_inputs": (TwoTower, lambda: (_img(3, 4), _img(3, 6))),
    "view_batch": (lambda: View("batch"), lambda: _img(2, 3, 4, 5)),
    "view_size": (lambda: View("size"), lambda: _img(2, 3, 4, 5)),
    "view_shape": (lambda: View("shape"), lambda: _img(2, 3, 4, 5)),
    "group_norm_transpose": (GroupNormNet, lambda: _img(2, 3, 6, 6)),
    "conv1d": (lambda: Wrap(torch.nn.Sequential(
        torch.nn.Conv1d(4, 6, 3, padding=1), torch.nn.PReLU(6),
        torch.nn.BatchNorm1d(6))), lambda: _img(2, 4, 9)),
}
for _kind in (torch.nn.LSTM, torch.nn.GRU):
    for _layers, _bidi in ((2, False), (1, True), (2, True)):
        CASES[f"{_kind.__name__}_l{_layers}_bidi{int(_bidi)}"] = (
            lambda k=_kind, n=_layers, b=_bidi: RNN(k, n, b),
            lambda: _img(3, 7, 5))
for _act in (torch.nn.LogSoftmax(dim=-1), torch.nn.Mish(),
             torch.nn.Softplus(), torch.nn.Softsign(), torch.nn.Tanhshrink(),
             torch.nn.Softshrink(0.3), torch.nn.Hardshrink(0.3),
             torch.nn.LogSigmoid(), torch.nn.ELU(0.7), torch.nn.GELU(),
             torch.nn.Hardtanh(-0.5, 0.5), torch.nn.Hardsigmoid(),
             torch.nn.LeakyReLU(0.2), torch.nn.ReLU6(), torch.nn.SiLU(),
             torch.nn.Softmax(dim=-1)):
    CASES[f"act_{type(_act).__name__}"] = (lambda a=_act: Act(a),
                                           lambda: _img(3, 6))
for _i, _fn in enumerate((
        F.silu, lambda x: F.leaky_relu(x, 0.2), lambda x: F.elu(x, 0.7),
        lambda x: F.log_softmax(x, dim=-1), F.hardswish, F.softplus,
        F.gelu, torch.sigmoid, torch.tanh, lambda x: F.softmax(x, dim=-1),
        lambda x: F.dropout(x, 0.3, False), F.relu)):
    CASES[f"functional_{_i}"] = (lambda f=_fn: Func(f), lambda: _img(3, 6))
def _model_input(case, a):
    """The converted model's layout of a torch input: channels last (a
    Conv1d's NCL as NLC), token ids as int32 (the JAX tests' dtype)."""
    if a.ndim == 4:
        a = a.transpose(0, 2, 3, 1)
    elif case == "conv1d":
        a = a.transpose(0, 2, 1)
    return a.astype(np.int32) if a.dtype == np.int64 else a


@pytest.mark.parametrize("case", sorted(CASES))
def test_conversion_matches_jax(case):
    make, example = CASES[case]
    torch.manual_seed(0)
    tm = make().eval()
    ex = example()
    (jm, jv), (pm, pv) = _both(tm, ex)
    # the same nodes, names and weights
    assert [n.name for n in jm.order] == [n.name for n in pm.order]
    assert jm._torch_export_map == pm._torch_export_map
    for part in ("params", "state"):
        _bit_equal_trees(pv[part], jax.tree_util.tree_map(np.asarray,
                                                          jv[part]))
    # the forwards
    xs = ex if isinstance(ex, tuple) else (ex,)
    ins = [_model_input(case, a) for a in xs]
    jy, _ = jax.jit(jm.apply)(jv, *ins)
    with torch.no_grad():
        py = pm.eval()(*(torch.from_numpy(np.ascontiguousarray(a))
                         for a in ins))
    _close(py.numpy(), jy)
    # the export back to torch
    sdj, sdp = J.export_state_dict(jm, jv), P.export_state_dict(pm, pv)
    assert list(sdj) == list(sdp)
    for k in sdj:
        assert sdp[k].dtype == sdj[k].dtype and not sdp[k].is_cuda
        assert torch.equal(sdp[k], sdj[k]), k
    fresh = make()
    fresh.load_state_dict(sdp, strict=True)


def test_trained_variables_export_from_the_module():
    """``export_state_dict`` of the port's trained variables (the
    module's own ``export_variables``, tensors moved off the model)
    equals that of the converter's numpy tree."""
    from bigdl_tpu_torch.utils import export_variables

    tm = SmallCNN().eval()
    pm, pv = P.from_torch_module(tm, example_input=_img(2, 3, 8, 8))
    a, b = P.export_state_dict(pm, pv), P.export_state_dict(
        pm, export_variables(pm))
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    tm.load_state_dict(b, strict=True)


class Odd(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.p = torch.nn.Parameter(torch.zeros(3))

    def forward(self, x):
        return torch.einsum("bi,i->b", x, self.p)


class Partial(torch.nn.Module):
    def forward(self, x):
        return torch.flatten(x, start_dim=2)


class BadView(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(20, 2)

    def forward(self, x):
        return self.fc(x.view(6, -1))


class DistinctKV(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.mha = torch.nn.MultiheadAttention(8, 2, batch_first=True)

    def forward(self, x):
        out, _ = self.mha(x, x * 2.0, x * 3.0)
        return out


class SeqFirstAttention(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.mha = torch.nn.MultiheadAttention(8, 2)

    def forward(self, x):
        out, _ = self.mha(x, x, x)
        return out


REFUSALS = {
    "odd_module": (Odd, lambda: _img(2, 3)),
    "partial_flatten": (Partial, lambda: _img(2, 3, 4, 4)),
    "output_padding": (lambda: torch.nn.Sequential(torch.nn.ConvTranspose2d(
        2, 2, 3, stride=2, padding=1, output_padding=1)),
        lambda: _img(1, 2, 4, 4)),
    "bn_momentum_none": (lambda: torch.nn.Sequential(
        torch.nn.Conv2d(2, 2, 1), torch.nn.BatchNorm2d(2, momentum=None)),
        lambda: _img(1, 2, 4, 4)),
    "bad_view": (BadView, lambda: _img(2, 3, 4, 5)),
    "distinct_k_v": (DistinctKV, lambda: _img(2, 5, 8)),
    "lstm_not_batch_first": (lambda: torch.nn.LSTM(5, 6),
                             lambda: _img(3, 7, 5)),
    "mha_not_batch_first": (SeqFirstAttention, lambda: _img(5, 2, 8)),
    "upsample_size": (lambda: torch.nn.Sequential(
        torch.nn.Upsample(size=(8, 8))), lambda: _img(1, 2, 4, 4)),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_jax(case):
    make, example = REFUSALS[case]
    errors = []
    for mod in (J, P):
        with pytest.raises((NotImplementedError, ValueError)) as e:
            mod.from_torch_module(make(), example_input=example())
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


def test_loss_and_optimizer_mappings_match_jax():
    for tloss in (torch.nn.CrossEntropyLoss(), torch.nn.MSELoss(),
                  torch.nn.L1Loss(), torch.nn.NLLLoss(), torch.nn.BCELoss(),
                  torch.nn.BCEWithLogitsLoss(), torch.nn.SmoothL1Loss()):
        assert (type(P.convert_torch_loss(tloss)).__name__
                == type(J.convert_torch_loss(tloss)).__name__)
    crit = pnn.MSECriterion()
    assert P.convert_torch_loss(crit) is crit
    lin = torch.nn.Linear(2, 2)
    for topt in (torch.optim.SGD(lin.parameters(), lr=0.05, momentum=0.9,
                                 weight_decay=1e-4, nesterov=True),
                 torch.optim.Adam(lin.parameters(), lr=3e-3,
                                  betas=(0.8, 0.99), eps=1e-7),
                 torch.optim.AdamW(lin.parameters(), lr=2e-5,
                                   weight_decay=0.02),
                 torch.optim.RMSprop(lin.parameters(), lr=1e-3, alpha=0.9)):
        j, p = J.convert_torch_optimizer(topt), P.convert_torch_optimizer(
            topt)
        assert type(j).__name__ == type(p).__name__
        for attr in ("lr", "momentum", "weight_decay", "nesterov", "beta1",
                     "beta2", "epsilon", "decay_rate"):
            if hasattr(j, attr):
                assert getattr(p, attr) == getattr(j, attr), attr
    lin2 = torch.nn.Linear(2, 2)
    for bad in (torch.optim.Adam([{"params": lin.parameters(), "lr": 1e-5},
                                  {"params": lin2.parameters(),
                                   "lr": 1e-3}]),
                torch.optim.Adagrad(lin.parameters())):
        msgs = []
        for mod in (J, P):
            with pytest.raises(NotImplementedError) as e:
                mod.convert_torch_optimizer(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(NotImplementedError, match="KLDivLoss"):
        P.convert_torch_loss(torch.nn.KLDivLoss())
    with pytest.raises(ValueError, match="from_torch_module"):
        P.export_state_dict(pnn.Linear(2, 2), {"params": {}})


# ---- the thirteen new leaves -------------------------------------------------

LEAVES = {
    "Conv2DTranspose_pad": (lambda N: N.Conv2DTranspose(3, 4, 3, stride=2,
                                                        padding=1),
                            (2, 5, 5, 3)),
    "Conv2DTranspose_same": (lambda N: N.Conv2DTranspose(
        3, 4, (3, 2), stride=(2, 1), padding="SAME"), (2, 5, 4, 3)),
    "Conv2DTranspose_valid": (lambda N: N.Conv2DTranspose(
        3, 2, 2, stride=2, padding="VALID", with_bias=False), (2, 3, 4, 3)),
    "UpSampling2D_nearest": (lambda N: N.UpSampling2D((2, 3)), (2, 3, 4, 2)),
    "UpSampling2D_bilinear": (lambda N: N.UpSampling2D(2, mode="bilinear"),
                              (2, 3, 4, 2)),
    "AddConstant": (lambda N: N.AddConstant(0.7), (3, 5)),
    "MulConstant": (lambda N: N.MulConstant(-1.3), (3, 5)),
    "LogSigmoid": (lambda N: N.LogSigmoid(), (3, 5)),
    "Mean": (lambda N: N.Mean(dim=1), (3, 4, 5)),
    "HardShrink": (lambda N: N.HardShrink(0.3), (3, 5)),
    "SoftShrink": (lambda N: N.SoftShrink(0.3), (3, 5)),
    "TanhShrink": (lambda N: N.TanhShrink(), (3, 5)),
    "Mish": (lambda N: N.Mish(), (3, 5)),
    "GroupNorm": (lambda N: N.GroupNorm(2, 6), (2, 3, 3, 6)),
}


@pytest.mark.parametrize("name", sorted(LEAVES))
def test_leaf_forward_and_gradients_match_jax(name):
    make, shape = LEAVES[name]
    rs = np.random.RandomState(7)
    x = (rs.randn(*shape) * 1.5).astype(np.float32)
    jl, pl = make(jnn), make(pnn)
    v = jax.tree_util.tree_map(np.asarray,
                               jl.init(jax.random.PRNGKey(1), x))
    for n, t in pl.named_parameters():
        with torch.no_grad():
            t.copy_(torch.from_numpy(np.array(v["params"][n])))
    jy = np.asarray(jl.apply(v, x)[0])
    w = rs.randn(*jy.shape).astype(np.float32)

    def loss(params, xx):
        return (jl.forward(params, v["state"], xx)[0] * w).sum()

    jgp, jgx = jax.grad(loss, argnums=(0, 1))(v["params"], x)
    xt = torch.from_numpy(x).requires_grad_(True)
    py = pl(xt)
    (py * torch.from_numpy(w)).sum().backward()
    _close(py.detach().numpy(), jy)
    _close(xt.grad.numpy(), jgx)
    for n, t in pl.named_parameters():
        _close(t.grad.numpy(), jgp[n])


@pytest.mark.parametrize("name", ["CSubTable", "CDivTable"])
def test_table_leaves_match_jax(name):
    rs = np.random.RandomState(8)
    a = rs.randn(3, 4).astype(np.float32)
    b = (rs.rand(3, 4) + 0.5).astype(np.float32)
    jl, pl = getattr(jnn, name)(), getattr(pnn, name)()
    w = rs.randn(3, 4).astype(np.float32)

    def loss(u, v):
        return (jl.forward({}, {}, u, v)[0] * w).sum()

    ga, gb = jax.grad(loss, argnums=(0, 1))(a, b)
    at, bt = (torch.from_numpy(t).requires_grad_(True) for t in (a, b))
    out = pl(at, bt)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach().numpy(), jl.forward({}, {}, a, b)[0])
    _close(at.grad.numpy(), ga)
    _close(bt.grad.numpy(), gb)
