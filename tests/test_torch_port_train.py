"""Port training slice (criterion, optim methods, triggers, dataset plan,
train step, Optimizer) against the JAX package, on the same numpy
inputs and the same initial weights (``load_jax_params``).  JAX matmuls
run at "highest" precision (tests/conftest.py) and the port in full
float32, so the two differ only in the order of float32 sums."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.data.dataset import ArrayDataSet as JArrayDataSet
from bigdl_tpu.data.dataset import batch_index_plan as jax_batch_index_plan
from bigdl_tpu.nn import attention as jattn
from bigdl_tpu.nn import criterion as jcrit
from bigdl_tpu.optim import optim_method as joptim
from bigdl_tpu.optim.optimizer import Optimizer as JOptimizer
from bigdl_tpu.optim.schedules import Default as JDefault
from bigdl_tpu.optim.trigger import Trigger as JTrigger
from bigdl_tpu_torch.data import DataSet
from bigdl_tpu_torch.data.dataset import batch_index_plan
from bigdl_tpu_torch.nn import (ClassNLLCriterion, CrossEntropyCriterion,
                                Transformer)
from bigdl_tpu_torch.optim import (SGD, Adam, Default, GradientClipping,
                                   Optimizer, Trigger)
from bigdl_tpu_torch.optim.train_step import clip_gradients

# the tiny LM of the slice test: 2 layers, d=32, 4 heads, vocab 64, seq 24
LM = dict(vocab_size=64, hidden_size=32, num_heads=4, num_layers=2,
          dropout=0.0)
SEQ, N_SEQS, BATCH = 24, 16, 8


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("targets", ["int", "onehot", "soft"])
def test_cross_entropy_matches_jax(targets):
    rs = np.random.RandomState(0)
    logits = (rs.randn(3, 5, 11) * 3).astype(np.float32)
    labels = rs.randint(0, 11, (3, 5))
    if targets == "int":
        tgt = labels.astype(np.int32)
    elif targets == "onehot":
        tgt = np.eye(11, dtype=np.float32)[labels]
    else:
        tgt = rs.dirichlet(np.ones(11), (3, 5)).astype(np.float32)
    for size_average in (True, False):
        want = jcrit.CrossEntropyCriterion(size_average)(
            jnp.asarray(logits), jnp.asarray(tgt))
        got = CrossEntropyCriterion(size_average)(torch.from_numpy(logits),
                                                  torch.from_numpy(tgt))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_cross_entropy_gradient_and_out_of_range_label():
    """The gather path's gradient is the one-hot path's, and a label
    outside the classes adds 0 as the JAX one-hot of it does."""
    rs = np.random.RandomState(1)
    logits = rs.randn(4, 7).astype(np.float32)
    labels = np.array([0, 6, 3, 9], np.int32)
    jg = jax.grad(lambda x: jcrit.CrossEntropyCriterion()(
        x, jnp.asarray(labels)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    loss = CrossEntropyCriterion()(x, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(
        jcrit.CrossEntropyCriterion()(jnp.asarray(logits),
                                      jnp.asarray(labels))), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True])
def test_class_nll_matches_jax(weighted):
    rs = np.random.RandomState(2)
    logp = np.log(rs.dirichlet(np.ones(6), 9)).astype(np.float32)
    labels = rs.randint(0, 6, 9).astype(np.int32)
    w = rs.rand(6).astype(np.float32) if weighted else None
    want = jcrit.ClassNLLCriterion(
        weights=None if w is None else jnp.asarray(w))(
        jnp.asarray(logp), jnp.asarray(labels))
    got = ClassNLLCriterion(weights=None if w is None else
                            torch.from_numpy(w))(torch.from_numpy(logp),
                                                 torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("name,kw", [
    ("adam", dict(learning_rate=1e-2, learning_rate_decay=0.1)),
    ("sgd", dict(learning_rate=0.1, learning_rate_decay=0.05,
                 momentum=0.9, weight_decay=1e-3)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, dampening=0.0,
                 nesterov=True)),
    ("sgd", dict(learning_rate=0.2)),
])
def test_optim_methods_match_jax_update(name, kw):
    """Several steps of the in-place update against the JAX method's
    pure update on the same gradients (step 0, 1, ...)."""
    rs = np.random.RandomState(3)
    shapes = [(4, 3), (3,)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    jm = {"adam": joptim.Adam, "sgd": joptim.SGD}[name](**kw)
    tm = {"adam": Adam, "sgd": SGD}[name](**kw)
    jp = [jnp.asarray(p) for p in params]
    js = jm.init_state(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = tm.init_state(tp)
    for step in range(4):
        grads = [rs.randn(*s).astype(np.float32) for s in shapes]
        jp, js = jm.update(step, [jnp.asarray(g) for g in grads], jp, js)
        tm.update(step, [torch.from_numpy(g) for g in grads], tp, ts)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
        assert tm.get_learning_rate(step) == pytest.approx(
            float(jm.get_learning_rate(step)))


def test_default_schedule():
    assert Default(0.5)(0.1, 4) == pytest.approx(
        float(JDefault(0.5)(0.1, 4)))


@pytest.mark.parametrize("n,batch,seed,epoch,drop_last,procs", [
    (16, 8, 42, 1, True, 1), (37, 8, 42, 3, True, 1), (37, 8, 7, 2, False, 1),
    (50, 12, 0, 1, False, 3), (10, 4, 5, 9, True, 2)])
def test_batch_index_plan_matches_jax(n, batch, seed, epoch, drop_last,
                                      procs):
    for pid in range(procs):
        kw = dict(shuffle=True, seed=seed, epoch=epoch, drop_last=drop_last,
                  process_id=pid, process_count=procs)
        got = list(batch_index_plan(n, batch, **kw))
        want = list(jax_batch_index_plan(n, batch, **kw))
        assert len(got) == len(want)
        for (s1, r1), (s2, r2) in zip(got, want):
            assert r1 == r2 and np.array_equal(s1, s2)


def test_array_dataset_batches_match_jax():
    rs = np.random.RandomState(4)
    x = rs.randn(21, 3).astype(np.float32)
    y = rs.randint(0, 5, 21)
    kw = dict(shuffle=True, seed=3, epoch=2, drop_last=False)
    for a, b in zip(DataSet.array(x, y).batches(8, **kw),
                    JArrayDataSet(x, y).batches(8, **kw)):
        assert sorted(a) == sorted(b)
        for key in a:
            assert np.array_equal(a[key], b[key])


def test_triggers():
    st = {"epoch": 1, "iteration": 0, "epoch_finished": False}
    it, ep = Trigger.max_iteration(3), Trigger.max_epoch(2)
    assert not it(st) and not ep(st)
    st.update(iteration=3, epoch=2)
    assert it(st) and not ep(st)
    st["epoch"] = 3
    assert ep(st)
    assert Trigger.or_(it, ep)(st) and Trigger.and_(it, ep)(st)
    assert it.boundary(1) == JTrigger.max_iteration(3).boundary(1) == 2


def test_gradient_clipping():
    rs = np.random.RandomState(6)
    gs = [rs.randn(5, 2).astype(np.float32) * 3, rs.randn(4).astype(
        np.float32)]
    tg = [torch.from_numpy(g.copy()) for g in gs]
    clip_gradients(tg, GradientClipping(-2.0, 2.5, l2_norm=1.5))
    c = [np.clip(g, -2.0, 2.5) for g in gs]
    norm = np.sqrt(sum(float((g * g).sum()) for g in c))
    for a, b in zip(tg, c):
        np.testing.assert_allclose(a.numpy(), b * min(1.0, 1.5 / norm),
                                   rtol=1e-6)


def _lm_data():
    rs = np.random.RandomState(0)
    ids = rs.randint(0, LM["vocab_size"], (N_SEQS, SEQ)).astype(np.int32)
    tgt = rs.randint(0, LM["vocab_size"], (N_SEQS, SEQ)).astype(np.int32)
    return ids, tgt


def test_optimizer_matches_jax_optimizer(tmp_path):
    """The slice as a whole: the tiny LM trained 5 iterations (3 epochs
    of 2 shuffled batches of 8) with Adam(1e-3) by the JAX Optimizer on the
    8-device CPU mesh and by the port's Optimizer on the CPU, from the same
    initial params.  Per-step losses within 1e-5: float32, and the JAX
    step sums its gradient over 8 shards.  Final params within 1e-4, a
    tenth of one Adam step: Adam's normalised update turns a float32
    difference in a near-zero gradient entry into a step of up to lr.
    The key bias is held through the trained logits instead: its exact
    gradient is 0 (softmax is shift-invariant over keys), so Adam's
    normalised step moves it by rounding noise that changes no output."""
    ids, tgt = _lm_data()
    jm = jattn.Transformer(**LM, mode="lm")
    init = _np(jm.init(jax.random.PRNGKey(0), ids[:1]))
    jopt = JOptimizer(jm, JArrayDataSet(ids, tgt),
                      jcrit.CrossEntropyCriterion(), batch_size=BATCH)
    jopt.set_optim_method(joptim.Adam(learning_rate=1e-3))
    jopt.set_end_when(JTrigger.max_iteration(5))
    jopt.set_initial_variables(init)
    jopt.set_train_summary(str(tmp_path))
    want = _np(jopt.optimize().variables["params"])
    want_losses = [v for _, v in jopt._train_summary.read_scalar("loss")]

    opt = (Optimizer(Transformer(**LM, seed=9), DataSet.array(ids, tgt),
                     CrossEntropyCriterion(), batch_size=BATCH,
                     device="cpu")
           .set_optim_method(Adam(learning_rate=1e-3))
           .set_end_when(Trigger.max_iteration(5))
           .set_initial_variables(init))
    trained = opt.optimize()
    assert opt.final_state["iteration"] == 5
    assert opt.final_state["epoch"] == jopt.final_state["epoch"] == 3
    assert len(want_losses) == 5
    np.testing.assert_allclose(opt.losses, want_losses, rtol=0, atol=1e-5)
    got = trained.variables["params"]
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    for path, w in flat_w:
        if path[-1].key == "bk":
            continue
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    want_logits = jm.forward(want, {}, jnp.asarray(ids[:4]))[0]
    # logits of order 1-3 over params within 1e-4
    np.testing.assert_allclose(trained.predict(ids[:4]), want_logits,
                               rtol=1e-4, atol=2e-4)
    assert not trained.model.training


def test_optimizer_needs_cuda_or_cpu(monkeypatch):
    ids, tgt = _lm_data()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Optimizer(Transformer(**LM), DataSet.array(ids, tgt),
                  CrossEntropyCriterion(), batch_size=BATCH)
    Optimizer(Transformer(**LM), DataSet.array(ids, tgt),
              CrossEntropyCriterion(), batch_size=BATCH, device="cpu")


def test_optimizer_refuses_dataset_without_a_batch():
    ids, tgt = _lm_data()
    opt = Optimizer(Transformer(**LM), DataSet.array(ids[:3], tgt[:3]),
                    CrossEntropyCriterion(), batch_size=BATCH, device="cpu")
    with pytest.raises(ValueError, match="no batch"):
        opt.set_end_when(Trigger.max_iteration(2)).optimize()


def test_optimizer_clipping_and_max_epoch():
    """Clipping setters reach the step; max_epoch(2) over 2 batches an
    epoch stops after 4 iterations with epoch 3, as the JAX Optimizer does."""
    ids, tgt = _lm_data()
    opt = (Optimizer(Transformer(**LM), DataSet.array(ids, tgt),
                     CrossEntropyCriterion(), batch_size=BATCH, device="cpu")
           .set_optim_method(SGD(learning_rate=0.5))
           .set_constant_gradient_clipping(-0.01, 0.01)
           .set_gradient_clipping_by_l2_norm(0.05)
           .set_end_when(Trigger.max_epoch(2)))
    before = [p.detach().clone() for p in opt.model.parameters()]
    opt.optimize()
    assert opt.clip == GradientClipping(-0.01, 0.01, 0.05)
    assert opt.final_state["iteration"] == 4
    assert opt.final_state["epoch"] == 3
    assert np.all(np.isfinite(opt.losses))
    moved = sum(float((p.detach() - b).norm()) ** 2
                for p, b in zip(opt.model.parameters(), before)) ** 0.5
    # every step moves at most lr * 0.05
    assert 0 < moved <= 4 * 0.5 * 0.05 + 1e-6
