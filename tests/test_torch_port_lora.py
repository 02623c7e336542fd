"""``bigdl_tpu_torch.nn.lora`` against ``bigdl_tpu.nn.lora`` (the specs
of ``tests/test_lora.py``): the wrapped model starts as the base model,
a converted torch MLP and a keras graph take adapters, ``match`` picks
the layers, ``merge_lora`` folds them back, and adapter-only training
with ``lora_filter`` as the trainable mask, through the ``Optimizer`` and
through ``ShardedParameterStep`` on 2 gloo ranks under
``AdamWeightDecay``, leaves the base bit-unchanged with losses within
1e-5 of the JAX package's.  The adapters' values are the JAX ones,
carried across by ``utils.convert`` (the two packages draw them from
different generators).

The rank workers of ``RankPool`` import this module, which therefore
imports JAX only inside the JAX-side helpers."""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.data import DataSet
from bigdl_tpu_torch.nn.lora import (LoRALinear, apply_lora, lora_filter,
                                     merge_lora)
from bigdl_tpu_torch.runtime import engine as engine_mod
from bigdl_tpu_torch.utils.convert import (export_variables,
                                           load_jax_keras_variables,
                                           load_jax_variables)
from test_torch_port_collectives import pools  # noqa: F401 (fixture)

TOL = 1e-5
SEED = 11


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _mlp(m):
    return m.Sequential([m.Linear(8, 16), m.Tanh(), m.Linear(16, 2)])


def _data(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(64, 8).astype(np.float32)
    return x, x @ rs.randn(8, 2).astype(np.float32)


def _np(tree):
    import jax

    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_lora(rank=4, alpha=8.0, **kw):
    """The JAX MLP, its LoRA twin and the twin's variables, with
    ``lora_b`` drawn too (JAX starts it at zero) so the bypass counts."""
    import jax
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.nn.lora import apply_lora as japply

    x, y = _data()
    jm = _mlp(jnn)
    v = _np(jm.init(jax.random.PRNGKey(0), x[:2]))
    lm, lv = japply(jm, v, rank=rank, alpha=alpha, **kw)
    lv = _np(lv)
    rs = np.random.RandomState(5)
    for p in lv["params"].values():
        if "lora_b" in p:
            p["lora_b"] = rs.randn(*p["lora_b"].shape).astype(
                np.float32) * 0.1
    return jm, v, lm, lv, x, y


def _port_lora(lv, rank=4, alpha=8.0, **kw):
    return load_jax_variables(apply_lora(_mlp(nn), rank=rank, alpha=alpha,
                                         **kw), lv)


def test_lora_starts_as_identity_and_leaves_the_caller_model():
    import jax
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.nn.lora import apply_lora as japply

    x, _ = _data()
    jm = _mlp(jnn)
    v = _np(jm.init(jax.random.PRNGKey(0), x[:2]))
    tm = load_jax_variables(_mlp(nn), v)
    lm = apply_lora(tm, rank=4, generator=torch.Generator().manual_seed(1))
    assert sum(isinstance(m, LoRALinear) for m in lm.layers) == 2
    assert not {id(p) for p in lm.parameters()} & \
        {id(p) for p in tm.parameters()}
    for m in lm.layers:
        if isinstance(m, LoRALinear):
            assert m.lora_a.shape == (m.inlined.weight.shape[0], 4)
            assert m.lora_b.shape == (4, m.inlined.out_features)
            assert not m.lora_b.any() and m.lora_a.any()
    with torch.no_grad():
        np.testing.assert_array_equal(lm(_t(x)).numpy(), tm(_t(x)).numpy())
    jl, jlv = japply(jm, v, rank=4)
    got = export_variables(lm)["params"]
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(_np(jlv["params"]))


def test_lora_forward_and_merge_match_jax():
    from bigdl_tpu.nn.lora import merge_lora as jmerge

    _, _, lm, lv, x, _ = _jax_lora()
    tl = _port_lora(lv)
    with torch.no_grad():
        got = tl(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(lm.apply(lv, x)[0]),
                               rtol=0, atol=TOL)
    dm, dv = jmerge(lm, lv)
    merged = merge_lora(tl)
    assert not any(isinstance(m, LoRALinear) for m in merged.modules())
    assert isinstance(tl.layers[0], LoRALinear)          # the caller's
    jd = export_variables(merged)["params"]
    for k in jd:
        np.testing.assert_allclose(jd[k]["weight"],
                                   np.asarray(dv["params"][k]["weight"]),
                                   rtol=0, atol=1e-6)
    with torch.no_grad():
        np.testing.assert_allclose(merged(_t(x)).numpy(), got, rtol=0,
                                   atol=TOL)


def test_match_predicate_selects_layers():
    from bigdl_tpu.nn.lora import LoRALinear as JLoRA

    jm, v, lm, lv, x, _ = _jax_lora(
        rank=2, match=lambda lin: lin.out_features == 2)
    tl = apply_lora(_mlp(nn), rank=2, match=lambda lin: lin.out_features == 2)
    assert [isinstance(m, LoRALinear) for m in tl.layers] == \
        [isinstance(m, JLoRA) for m in lm.layers] == [False, False, True]
    mask = lora_filter(tl)
    assert mask["2_Linear"] == {"weight": False, "bias": False,
                                "lora_a": True, "lora_b": True}
    assert not any(mask["0_Linear"].values())


def test_lora_filter_is_the_jax_tree():
    import jax
    from bigdl_tpu.nn.lora import lora_filter as jfilter

    _, _, _, lv, _, _ = _jax_lora()
    tl = _port_lora(lv)
    want = jfilter(lv["params"])
    for got in (lora_filter(tl), lora_filter(export_variables(tl)["params"])):
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        assert jax.tree_util.tree_leaves(got) == \
            jax.tree_util.tree_leaves(want)


def _keras(m, I, M):
    inp = I((8,))
    h = m.Linear(8, 16)(inp)
    h = m.ReLU()(h)
    out = m.Linear(16, 3)(h)
    return M(inp, out)


def test_lora_on_a_keras_graph():
    import jax
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.keras.engine import Input as JInput, Model as JModel
    from bigdl_tpu.nn.lora import apply_lora as japply
    from bigdl_tpu_torch.keras.engine import Input, Model

    jmodel = _keras(jnn, JInput, JModel)
    x = np.random.RandomState(1).randn(16, 8).astype(np.float32)
    v = _np(jmodel.init(jax.random.PRNGKey(0), x))
    jl, jlv = japply(jmodel, v, rank=2)
    jlv = _np(jlv)
    for p in jlv["params"].values():
        if "lora_b" in p:
            p["lora_b"] = np.full(p["lora_b"].shape, 0.05, np.float32)
    tl = apply_lora(_keras(nn, Input, Model), rank=2)
    assert sum(isinstance(n.layer, LoRALinear) for n in tl.order) == 2
    load_jax_keras_variables(tl, jl, jlv)
    with torch.no_grad():
        got = tl(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jl.apply(jlv, x)[0]),
                               rtol=0, atol=TOL)
    merged = merge_lora(tl)
    assert not any(isinstance(n.layer, LoRALinear) for n in merged.order)
    with torch.no_grad():
        np.testing.assert_allclose(merged(_t(x)).numpy(), got, rtol=0,
                                   atol=TOL)


def test_lora_on_a_converted_torch_mlp():
    """A stock torch MLP converted by both packages: LoRA wraps its two
    Linear nodes, and the wrapped graph starts as the converted one."""
    from bigdl_tpu.nn.lora import apply_lora as japply
    from bigdl_tpu.utils.torch_convert import from_torch_module as jconv
    from bigdl_tpu_torch.utils.torch_convert import from_torch_module

    torch.manual_seed(0)
    tm = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                             torch.nn.Linear(16, 4))
    jmodel, jv = jconv(tm, example_input=torch.zeros(1, 8))
    model = from_torch_module(tm, example_input=torch.zeros(1, 8))
    if isinstance(model, tuple):
        model = model[0]
    jl, jlv = japply(jmodel, jv, rank=2)
    tl = apply_lora(model, rank=2)
    assert sum(isinstance(n.layer, LoRALinear) for n in tl.order) == \
        sum(type(n.layer).__name__ == "LoRALinear" for n in jl.order) == 2
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(tl(_t(x)).numpy(),
                                   model(_t(x)).numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tl(_t(x)).numpy(),
                                   np.asarray(jl.apply(jlv, x)[0]),
                                   rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# adapter-only training
# ---------------------------------------------------------------------------

def _jax_optimizer_losses(lm, lv, x, y, steps, tmp):
    from bigdl_tpu import nn as jnn
    from bigdl_tpu import optim as joptim
    from bigdl_tpu.data.dataset import ArrayDataSet
    from bigdl_tpu.nn.lora import lora_filter as jfilter
    from bigdl_tpu.runtime.engine import Engine, init_engine

    Engine.reset()
    init_engine(data=1)
    try:
        opt = joptim.Optimizer(lm, ArrayDataSet(x, y), jnn.MSECriterion(),
                               batch_size=32, seed=3)
        opt.set_optim_method(joptim.AdamWeightDecay(learning_rate=5e-3,
                                                    weight_decay=0.1))
        opt.set_end_when(joptim.Trigger.max_iteration(steps))
        opt.set_initial_variables(lv)
        opt.trainable_mask = jfilter(lv["params"])
        opt.set_train_summary(tmp)
        trained = opt.optimize()
        losses = [v for _, v in opt._train_summary.read_scalar("loss")]
        return losses, _np(trained.variables["params"])
    finally:
        Engine.reset()


def test_adapter_only_training_through_the_optimizer(tmp_path):
    _, _, lm, lv, x, y = _jax_lora()
    want, jparams = _jax_optimizer_losses(lm, lv, x, y, 6, str(tmp_path))
    tl = _port_lora(lv)
    opt = optim.Optimizer(tl, DataSet.array(x, y), nn.MSECriterion(),
                          batch_size=32, seed=3, device="cpu")
    opt.set_optim_method(optim.AdamWeightDecay(
        learning_rate=5e-3, weight_decay=0.1)).set_end_when(
        optim.Trigger.max_iteration(6)).set_initial_variables(lv)
    opt.trainable_mask = lora_filter(tl)
    trained = opt.optimize()
    np.testing.assert_allclose(opt.losses, want, rtol=TOL, atol=TOL)
    got = trained.variables["params"]
    for k, p in lv["params"].items():
        for name in ("weight", "bias"):
            np.testing.assert_array_equal(got[k][name], p[name])
        assert not np.array_equal(got[k]["lora_b"], p["lora_b"])
        np.testing.assert_allclose(got[k]["lora_a"], jparams[k]["lora_a"],
                                   rtol=0, atol=TOL)


def _port_sharded(rank, world, lv, x, y, steps):
    from bigdl_tpu_torch.optim.train_step import ShardedParameterStep
    from bigdl_tpu_torch.runtime import Engine

    tl = _port_lora(lv)
    st = ShardedParameterStep(tl, nn.MSECriterion(), optim.AdamWeightDecay(
        learning_rate=5e-3, weight_decay=0.1), Engine.get().mesh, seed=SEED,
        trainable_mask=lora_filter(tl))
    b = len(y) // world
    xs, ys = (torch.as_tensor(a[rank * b:(rank + 1) * b]) for a in (x, y))
    lv_, _ = st.train_bundle(0, [xs] * steps, [ys] * steps)
    return dict(losses=lv_.numpy(), params=export_variables(tl)["params"])


def _jax_sharded(lm, lv, x, y, steps):
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.nn.lora import lora_filter as jfilter
    from bigdl_tpu.optim.optim_method import AdamWeightDecay
    from bigdl_tpu.optim.train_step import ShardedParameterStep
    from test_torch_port_collectives import _jax_mesh

    st = ShardedParameterStep(
        lm, jnn.MSECriterion(),
        AdamWeightDecay(learning_rate=5e-3, weight_decay=0.1), _jax_mesh(2),
        lv, trainable_mask=jfilter(lv["params"]))
    st.set_step_seed(SEED + 1)
    xd, yd = st.shard_batch(x), st.shard_batch(y)
    losses = []
    for i in range(steps):
        lval, _ = st.train_bundle_device(i, [xd], [yd])
        losses.append(float(np.asarray(lval)[0]))
    return np.asarray(losses), _np(st.get_variables()["params"])


def test_adapter_only_training_through_the_sharded_step(pools):
    engine_mod.Engine.reset()
    _, _, lm, lv, x, y = _jax_lora()
    want, jparams = _jax_sharded(lm, lv, x, y, 4)
    got = pools(2).run(_port_sharded, lv, x, y, 4)
    for g in got:
        np.testing.assert_allclose(g["losses"], want, rtol=TOL, atol=TOL)
        for k, p in lv["params"].items():
            for name in ("weight", "bias"):
                np.testing.assert_array_equal(g["params"][k][name], p[name])
            for name in ("lora_a", "lora_b"):
                np.testing.assert_allclose(g["params"][k][name],
                                           jparams[k][name], rtol=0,
                                           atol=TOL)
            assert not np.array_equal(g["params"][k]["lora_b"],
                                      p["lora_b"])
