"""Layout training and serving on the port over gloo ranks on the CPU
(``bigdl_tpu_torch.parallel.gspmd``, ``mesh_policy``, the
``parallelism=`` surfaces and ``InferenceModel(layout=)``), against the
JAX package's ``fit_layout`` on a CPU mesh of as many devices
(``tests/test_layout.py``'s specs).

Ranks come from ``test_torch_port_collectives.RankPool``; every rank
runs the same ``fit_layout`` on its shards, and rank ``r`` holds the
shards JAX device ``r`` holds.  The JAX references run while the ranks
work.  The LM is ``tests/test_layout.py``'s at two layers (vocab 32,
hidden 16, 2 heads, FFN 32), from the JAX init of ``PRNGKey(seed)``
carried by ``utils.convert``, dropout 0, Adam 1e-2, batch 8, two
epochs of 16 rows (4 steps: DTensor's dispatch makes a step of this
tiny LM about 0.8 s on 4 gloo ranks).

Tolerances:
- ``"dp"``: losses within 1e-5 (relative and absolute): float32 with
  the batch's sum split over the ranks.
- ``"fsdp:2,tp:2"``, ``"dp:2,tp:2"``, ``"dp:2,seq:2"``: losses within
  ``tests/test_layout.py:320``'s ``rtol=2e-4, atol=2e-5``; parameters
  and Adam moments, every rank's local shard against JAX device r's
  shard, within the same bound (4 Adam steps at 1e-2; the moments' v is
  a square of the gradients, held relative).  The key bias ``bk`` is
  held by shape only: its gradient is zero but for rounding noise (a
  softmax ignores what a row's logits share), which Adam scales to
  whole steps in either package (ROADMAP C.1, C.4: compare the trained
  logits, which the losses do, not ``bk``).
- the trained model's ``predict`` on the layout against the plain
  forward of its gathered weights in one process: 1e-5 (the split
  products sum in another order).
- the gradients of one step (after training) against one process's
  autograd on the gathered weights: 1e-5 absolute and relative
  (reduction order), each rank's local shard against its slice of the
  whole gradient.
- ``InferenceModel(layout=)`` against the unsharded port: 1e-5 (the
  all-reduced row-split products sum in another order); with
  ``decode=`` the greedy tokens equal and the summed log-probs within
  1e-5, with ``weight_quant="int8"`` the predictions within 1e-5.
- one rank under ``"dp"``, ``"fsdp"``, ``"tp"``, ``"seq"``: losses
  equal to a plain loop's to the bit (each placement's local tensor is
  the whole tensor, each collective a copy, each op the plain loop's).
- surfaces (keras, Estimator, forecaster): they train (the second
  epoch's mean loss below the first's) and keep JAX's refusals."""

import queue

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.nn.attention import Transformer
from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
from test_torch_port_collectives import WAIT_S, pools  # noqa: F401

VOCAB, T, SEED, LR = 32, 8, 7, 1e-2
LAYERS = 2
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
DP_TOL = dict(rtol=1e-5, atol=1e-5)
PARS = ("dp", "fsdp:2,tp:2", "dp:2,tp:2", "dp:2,seq:2")
ONE_RANK_PARS = ("dp", "fsdp", "tp", "seq")
ONE_RANK_AXIS = {"dp": "data", "fsdp": "fsdp", "tp": "tp", "seq": "seq"}


class LMFlat(Transformer):
    """The LM with (b, t) ids in and flat (b t, V) logits out, as
    ``tests/test_layout.py``'s ``_LMWrap``."""

    def forward(self, ids, key=None):
        return super().forward(ids, key=key).reshape(-1, self.vocab_size)


class FlatCE:
    def __init__(self):
        self.ce = CrossEntropyCriterion()

    def __call__(self, out, y):
        return self.ce(out, y.reshape(-1))


def _lm():
    return LMFlat(VOCAB, 16, 2, 32, num_layers=LAYERS, dropout=0.0,
                  mode="lm")


def _data():
    rs = np.random.RandomState(0)
    x = rs.randint(2, VOCAB, (16, T)).astype(np.int32)
    return x, np.roll(x, -1, 1).astype(np.int32)


def _tagged(rank, world, name, fn, *args):
    return name, fn(rank, world, *args)


class Jobs:
    """Every rank job of the module queued at once on the 4-rank pool
    (each rank runs them in turn), answers read by name: the JAX
    references run while the ranks work."""

    def __init__(self, pool):
        self.pool = pool
        self.done = {}

    def submit(self, name, fn, *args):
        for q in self.pool.inq:
            q.put((_tagged, (name, fn) + args))

    def get(self, name, timeout=WAIT_S):
        while len(self.done.get(name, {})) < self.pool.world:
            try:
                rank, ok, val = self.pool.outq.get(timeout=timeout)
            except queue.Empty:
                self.pool.broken = True
                raise TimeoutError(f"{name}: the ranks gave no answer in "
                                   f"{timeout} s")
            if not ok:
                self.pool.broken = True
                raise RuntimeError(f"rank {rank}:\n{val}")
            self.done.setdefault(val[0], {})[rank] = val[1]
        return [self.done[name][r] for r in range(self.pool.world)]


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_lm():
    import jax.numpy as jnp
    from bigdl_tpu.nn.attention import Transformer as JT
    from bigdl_tpu.nn.criterion import CrossEntropyCriterion as JCE

    class Wrap:
        def __init__(self, m):
            self.m = m

        def init(self, rng, x):
            return self.m.init(rng, x)

        def forward(self, params, state, x, training=False, rng=None):
            out, st = self.m.forward(params, state, x, training=training,
                                     rng=rng)
            return out.reshape(-1, VOCAB), st

    class FlatJCE:
        def __init__(self):
            self.ce = JCE()

        def forward(self, out, y):
            return self.ce.forward(out, jnp.reshape(y, (-1,)))

    return Wrap(JT(VOCAB, hidden_size=16, num_heads=2, ffn_size=32,
                   num_layers=LAYERS, dropout=0.0, mode="lm")), FlatJCE()


def _jax_init(x):
    import jax

    m, _ = _jax_lm()
    v = m.init(jax.random.PRNGKey(SEED), x[:1])
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v)


def _jax_fit(par, x, y):
    """JAX fit_layout on 4 CPU devices: (stats, {path: {device id:
    shard}} of the params and of each Adam slot, predictions, the
    shard report, the gauges)."""
    import jax
    from bigdl_tpu.data import ArrayDataSet
    from bigdl_tpu.optim.metrics import global_metrics
    from bigdl_tpu.optim.optim_method import Adam
    from bigdl_tpu.parallel.gspmd import fit_layout
    from bigdl_tpu.parallel.layout import path_str

    m, ce = _jax_lm()
    trained, stats = fit_layout(m, ce, Adam(learning_rate=LR),
                                ArrayDataSet(x, y), parallelism=par,
                                batch_size=8, epochs=2, seed=SEED,
                                log_every=0, devices=jax.devices()[:4])
    eng = trained._engine

    def shards(tree):
        return {path_str(p): {s.device.id: np.asarray(s.data)
                              for s in a.addressable_shards}
                for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}

    gauges = {k: v for k, v in global_metrics().gauges.items()
              if k.startswith("parallel.layout.")}
    return dict(stats=stats, params=shards(eng.params),
                m=shards(eng.opt_state["m"]), v=shards(eng.opt_state["v"]),
                report=eng.shard_report(), gauges=gauges)


# ---------------------------------------------------------------------------
# rank workers
# ---------------------------------------------------------------------------

def _grads_check(step, variables, x, y):
    """(layout loss, one process's loss, the largest gradient error,
    every local gradient its parameter's slice of the whole one)."""
    from torch.distributed.tensor import distribute_tensor

    from bigdl_tpu_torch.utils.convert import load_jax_variables

    ref = load_jax_variables(_lm(), variables).train(True)
    loss_ref = FlatCE()(ref(torch.as_tensor(x)), torch.as_tensor(y).long())
    loss_ref.backward()
    want = dict(ref.named_parameters())
    loss, grads = step.gradients(None, x, y)
    errs, placed = [], True
    for name, p, g in zip(step.names, step.params, grads):
        placed &= tuple(g.placements) == tuple(p.placements)
        w = want[name].grad
        errs.append(float((g.full_tensor() - w).abs().max()))
        mine = distribute_tensor(w, p.device_mesh, p.placements,
                                 src_data_rank=None).to_local()
        placed &= torch.allclose(g.to_local(), mine, rtol=1e-5, atol=1e-5)
    return float(loss.full_tensor()), float(loss_ref), max(errs), placed


def _fit_worker(rank, world, variables, x, y, par):
    from bigdl_tpu_torch.data.dataset import ArrayDataSet
    from bigdl_tpu_torch.optim.metrics import global_metrics
    from bigdl_tpu_torch.optim.optim_method import Adam
    from bigdl_tpu_torch.parallel import fit_layout
    from bigdl_tpu_torch.parallel.layout import path_str
    from bigdl_tpu_torch.utils.convert import load_jax_variables

    model = load_jax_variables(_lm(), variables)
    trained, stats = fit_layout(model, FlatCE(), Adam(learning_rate=LR),
                                ArrayDataSet(x, y), parallelism=par,
                                batch_size=8, epochs=2, seed=SEED,
                                log_every=0, device="cpu")
    step = trained._step
    names = [path_str(n) for n in step.names]
    local = {n: p.to_local().detach().numpy().copy()
             for n, p in zip(names, step.params)}
    slots = {k: {n: t.to_local().numpy().copy()
                 for n, t in zip(names, step.opt_state[k])}
             for k in ("m", "v")}
    pred = trained.predict(x[:8])
    variables_after = trained.variables          # a gather: every rank
    with torch.no_grad():
        plain = load_jax_variables(_lm(), variables_after).eval()(
            torch.as_tensor(x[:8])).numpy()[:8]
    grads = _grads_check(step, variables_after, x[:8], y[:8])
    trained.set_variables(variables_after)
    round_trip = np.array_equal(trained.predict(x[:8]), pred)
    try:
        trained.set_variables({"params": {"wrong": np.zeros((2,))}})
        refused = ""
    except ValueError as e:
        refused = str(e)
    stats.pop("train_time_s")
    gauges = {k: v for k, v in global_metrics().gauges.items()
              if k.startswith("parallel.layout.")}
    return dict(stats=stats, local=local, m=slots["m"], v=slots["v"],
                pred=pred, plain=plain, grads=grads,
                report=step.shard_report(),
                round_trip=round_trip, refused=refused, gauges=gauges,
                placements={n: str(p.placements)
                            for n, p in zip(names, step.params)})


def _one_rank_worker(rank, world, variables, x, y):
    """At world 1, each policy's ``fit_layout`` losses and placements,
    and the same steps in a plain loop on plain tensors."""
    from bigdl_tpu_torch.data.dataset import ArrayDataSet, DataSet
    from bigdl_tpu_torch.optim.optim_method import Adam
    from bigdl_tpu_torch.parallel import fit_layout
    from bigdl_tpu_torch.utils.convert import load_jax_variables

    model = load_jax_variables(_lm(), variables).train(True)
    opt, params = Adam(learning_rate=LR), list(model.parameters())
    state, plain = opt.init_state(params), []
    for epoch in range(2):
        for mb in DataSet.array(x, y).batches(8, shuffle=True, seed=SEED,
                                              epoch=epoch):
            for p in params:
                p.grad = None
            loss = FlatCE()(model(torch.as_tensor(mb["input"])),
                            torch.as_tensor(mb["target"]).long())
            loss.backward()
            with torch.no_grad():
                opt.apply(opt.step_tensors(len(plain), torch.device("cpu")),
                          [p.grad for p in params], params, state)
            plain.append(float(loss.detach()))
    out = {"plain": plain}
    for par in ONE_RANK_PARS:
        trained, stats = fit_layout(
            load_jax_variables(_lm(), variables), FlatCE(),
            Adam(learning_rate=LR), ArrayDataSet(x, y), parallelism=par,
            batch_size=8, epochs=2, seed=SEED, log_every=0, device="cpu")
        out[par] = (stats["losses"], trained._step.mesh.mesh_dim_names,
                    sorted({str(p.placements)
                            for p in trained._step.params}))
    return out


@pytest.fixture(scope="module")
def jobs(pools):
    x, y = _data()
    variables = _jax_init(x)
    one = Jobs(pools(1))
    one.submit("one_rank", _one_rank_worker, variables, x, y)
    q = Jobs(pools(4))
    for par in PARS:
        q.submit(par, _fit_worker, variables, x, y, par)
    q.submit("refusals", _refusal_worker, x, y)
    q.submit("surfaces", _surface_worker, *_surface_data())
    q.submit("serve", _serve_worker, variables, x)
    q.one_rank = one
    return q


@pytest.mark.parametrize("par", ONE_RANK_PARS)
def test_one_rank_keeps_the_named_axis_and_the_plain_bits(jobs, par):
    """One device keeps the policy's axis at size 1: its own Shard
    placements (each the whole tensor) go through the model's ops and
    local_map calls, and the losses equal a plain loop's to the bit."""
    got = jobs.one_rank.get("one_rank")[0]
    losses, dims, placements = got[par]
    assert dims == (ONE_RANK_AXIS[par],)
    assert losses == got["plain"]
    assert any("Shard" in p for p in placements) == (par in ("fsdp", "tp"))


@pytest.fixture(scope="module")
def runs(jobs):
    """par -> (the port's rank answers, the JAX run)."""
    x, y = _data()
    want = {par: _jax_fit(par, x, y) for par in PARS}
    return x, y, {par: (jobs.get(par), want[par]) for par in PARS}


@pytest.mark.parametrize("par", PARS)
def test_fit_layout_losses_equal_jax(runs, par):
    _, _, out = runs
    got, want = out[par]
    tol = DP_TOL if par == "dp" else LOSS_TOL
    losses = got[0]["stats"]["losses"]
    assert len(losses) == 4
    np.testing.assert_allclose(losses, want["stats"]["losses"], **tol)
    for r in range(1, 4):                  # every rank the same
        assert got[r]["stats"] == got[0]["stats"]
    assert np.mean(losses[2:]) < np.mean(losses[:2])
    s, w = got[0]["stats"], want["stats"]
    for k in ("epochs", "num_samples", "iterations", "parallelism", "mesh",
              "replicated_params", "collective_bytes_by_axis",
              "param_bytes_per_chip"):
        assert s[k] == w[k], k
    assert got[0]["gauges"] == want["gauges"]


@pytest.mark.parametrize("par", PARS)
def test_every_rank_holds_jax_device_r_shards(runs, par):
    """Params and both Adam slots: rank r's local shard is JAX device
    r's shard, shape and values."""
    import jax

    _, _, out = runs
    got, want = out[par]
    tol = DP_TOL if par == "dp" else LOSS_TOL
    for r in range(4):
        dev = jax.devices()[r].id
        for kind, key in (("local", "params"), ("m", "m"), ("v", "v")):
            assert set(got[r][kind]) == set(want[key])
            for path, arr in got[r][kind].items():
                ref = want[key][path][dev]
                assert arr.shape == ref.shape, (par, r, kind, path)
                if path.endswith("/bk"):
                    continue      # rounding noise under Adam (C.1, C.4)
                np.testing.assert_allclose(arr, ref, err_msg=f"{kind} "
                                           f"{path} rank {r}", **tol)


@pytest.mark.parametrize("par", PARS)
def test_shard_report_predict_and_variables(runs, par):
    _, _, out = runs
    got, want = out[par]
    assert got[0]["report"] == want["report"]
    for r in range(4):
        assert got[r]["pred"].shape == (8, VOCAB)
        np.testing.assert_allclose(got[r]["pred"], got[r]["plain"],
                                   rtol=1e-5, atol=1e-5)
        assert got[r]["round_trip"]
        assert "structure" in got[r]["refused"]
    if par == "fsdp:2,tp:2":
        assert got[0]["placements"]["embedding"] == \
            "(Shard(dim=0), Shard(dim=0))"
        assert got[0]["local"]["dec0/attn/wq"].shape == (8, 8)
        assert got[0]["m"]["dec0/attn/wq"].shape == (8, 8)


@pytest.mark.parametrize("par", PARS)
def test_reduced_gradients_equal_one_process(runs, par):
    """After training: one more forward and backward on the layout, its
    gradients reduced and placed as their parameters, against one
    process's autograd on the gathered weights."""
    _, _, out = runs
    for r, got in enumerate(out[par][0]):
        loss, loss_ref, err, placed = got["grads"]
        assert abs(loss - loss_ref) <= 1e-5 and err <= 1e-5, (r, got)
        assert placed


def _refusal_worker(rank, world, x, y):
    from bigdl_tpu_torch.data.dataset import ArrayDataSet
    from bigdl_tpu_torch.optim.optim_method import SGD
    from bigdl_tpu_torch.parallel import fit_layout

    texts = []
    for rows, batch in ((24, 6), (4, 8)):
        try:
            fit_layout(_lm(), FlatCE(), SGD(learning_rate=0.1),
                       ArrayDataSet(x[:rows], y[:rows]),
                       parallelism="dp:2,fsdp:2", batch_size=batch,
                       device="cpu")
        except ValueError as e:
            texts.append(str(e))
    return texts


def test_fit_layout_refusals_are_jax_texts(jobs):
    import jax
    from bigdl_tpu.data import ArrayDataSet
    from bigdl_tpu.optim.optim_method import SGD
    from bigdl_tpu.parallel.gspmd import fit_layout

    x, y = _data()
    want = []
    for rows, batch in ((24, 6), (4, 8)):
        m, ce = _jax_lm()
        with pytest.raises(ValueError) as e:
            fit_layout(m, ce, SGD(0.1), ArrayDataSet(x[:rows], y[:rows]),
                       parallelism="dp:2,fsdp:2", batch_size=batch,
                       devices=jax.devices()[:4])
        want.append(str(e.value))
    assert "batch shards" in want[0] and "no batch" in want[1]
    for got in jobs.get("refusals"):
        assert got == want


# ---------------------------------------------------------------------------
# the surfaces: keras fit, the Estimator, a forecaster, InferenceModel
# ---------------------------------------------------------------------------

def _surface_worker(rank, world, x, y, wx, wy):
    import os

    from bigdl_tpu_torch import keras as K
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.estimator import Estimator
    from bigdl_tpu_torch.forecast import TCNForecaster
    from bigdl_tpu_torch.optim.optim_method import SGD
    from bigdl_tpu_torch.runtime import Engine

    out = {}
    km = K.Sequential([K.Dense(6, 8), K.Activation("relu"),
                       K.Dense(8, 2)]).compile(SGD(learning_rate=0.2),
                                               "mse")
    km.fit(x, y, batch_size=8, nb_epoch=3, parallelism="tp:2,dp",
           validation_data=(x, y), device="cpu")
    out["keras_pred"] = km.predict(x[:4]).shape
    out["keras_losses"] = km._trained.losses
    refusals = []
    for kw in (dict(checkpoint_path="/nonexistent/ck"),
               dict(seq_parallel=True)):
        try:
            km.fit(x, y, batch_size=8, parallelism="dp", device="cpu", **kw)
        except ValueError as e:
            refusals.append(str(e))
    out["keras_refusals"] = refusals

    def est(config):
        return Estimator.from_module(
            model_creator=lambda cfg: nn.Sequential(
                [nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 2)]),
            optimizer_creator=lambda cfg: SGD(learning_rate=0.2),
            loss_creator=lambda cfg: nn.MSECriterion(),
            config=config, device="cpu")

    e = est({"parallelism": "dp", "seed": 3})
    stats = e.fit((x, y), epochs=4, batch_size=8, validation_data=(x, y))
    stats.pop("train_time_s")
    out["est_stats"] = stats
    out["est_losses"] = e._trained.losses
    out["est_pred"] = e.predict(x[:4]).shape
    out["est_eval"] = e.evaluate((x, y), [])
    # the config key, then the engine's, then BIGDL_TPU_PARALLELISM
    Engine.get().config.parallelism = "tp:2,dp"
    out["engine_mesh"] = est({}).fit((x, y), epochs=1, batch_size=8)["mesh"]
    Engine.get().config.parallelism = None
    os.environ["BIGDL_TPU_PARALLELISM"] = "dp"
    try:
        Engine.reset()
        out["env_mesh"] = est({}).fit((x, y), epochs=1,
                                      batch_size=8)["mesh"]
    finally:
        del os.environ["BIGDL_TPU_PARALLELISM"]
        Engine.reset()
    try:
        est({"parallelism": "dp"}).fit((x, y), epochs=1, batch_size=8,
                                       fault_tolerance=True)
    except ValueError as err:
        out["est_refusal"] = str(err)

    f = TCNForecaster(24, 4, 1, 1, device="cpu")
    f.fit((wx, wy), epochs=1, batch_size=8, parallelism="dp")
    out["fc_pred"] = f.predict(wx[:4]).shape
    out["fc_stats"] = sorted(f._layout_stats)
    try:
        f.fit((wx, wy), parallelism="dp", validation_data=(wx, wy))
    except ValueError as err:
        out["fc_refusal"] = str(err)
    return out


def _surface_data():
    from test_torch_port_forecast import _windows

    rs = np.random.RandomState(1)
    x = rs.randn(32, 6).astype(np.float32)
    y = (x @ rs.randn(6, 2) * 0.5).astype(np.float32)
    return (x, y) + tuple(_windows(32, 24, 4, 1))


def test_surfaces_train_under_parallelism(jobs):
    for got in jobs.get("surfaces"):
        assert got["keras_pred"] == (4, 2)
        kl = got["keras_losses"]
        assert len(kl) == 12 and np.mean(kl[-4:]) < np.mean(kl[:4])
        assert "checkpoint_path" in got["keras_refusals"][0]
        assert "exclusive" in got["keras_refusals"][1]
        s = got["est_stats"]
        assert s["parallelism"] == "dp"
        assert s["mesh"] == {"data": 4, "fsdp": 1, "tp": 1, "seq": 1}
        el = got["est_losses"]
        assert s["first_loss"] == el[0] and s["final_loss"] == el[-1]
        assert len(el) == 16 and np.mean(el[-4:]) < np.mean(el[:4])
        assert "Loss" in s["validation"]
        assert got["est_pred"] == (4, 2)
        assert got["engine_mesh"]["tp"] == 2
        assert got["env_mesh"]["data"] == 4
        assert "fault_tolerance" in got["est_refusal"]
        assert got["fc_pred"][0] == 4
        assert "losses" in got["fc_stats"]
        assert "validation_data" in got["fc_refusal"]


def _serve_worker(rank, world, variables, x):
    from bigdl_tpu_torch.serving.decode_engine import DecodeConfig
    from bigdl_tpu_torch.serving.inference_model import InferenceModel
    from bigdl_tpu_torch.utils.convert import load_jax_variables

    ref = InferenceModel(load_jax_variables(_lm(), variables), device="cpu",
                         batch_buckets=(1, 4))
    im = InferenceModel(load_jax_variables(_lm(), variables), device="cpu",
                        batch_buckets=(1, 4), layout="tp:2,dp")
    emb = im.model.embedding
    out = {"emb_local": tuple(emb.to_local().shape),
           "pred": [(im.predict(x[:n]), ref.predict(x[:n]))
                    for n in (1, 3, 4, 6)]}
    im2 = InferenceModel(load_jax_variables(_lm(), variables), device="cpu",
                         batch_buckets=(4,), layout=im.layout)
    out["pred_resolved"] = (im2.predict(x[:4]), ref.predict(x[:4]))
    # A.3.7: decode= and weight_quant="int8" on the layout, each against
    # the unsharded port
    served = {}
    prompts = [row[:n] for row, n in zip(x, (3, 5, 2))]
    for name, kw in (("decode", dict(decode=DecodeConfig(
            slots=2, page_size=4, pages_per_slot=3, max_new_tokens=3,
            eos_id=-1))), ("int8", dict(weight_quant="int8"))):
        pair = [InferenceModel(load_jax_variables(_lm(), variables),
                               device="cpu", batch_buckets=(4,), **lay, **kw)
                for lay in (dict(layout="tp:2,dp"), {})]
        if name == "decode":
            served[name] = [[(r.tokens.tolist(), float(r.logp))
                             for r in m.generate(prompts,
                                                 return_results=True)]
                            for m in pair]
            for m in pair:
                m.stop()
        else:
            served[name] = [m.predict(x[:4]) for m in pair]
    out["a37"] = served
    # the fused LayerNorm (the IR "fused" rewrite's) on local rows, and a
    # kernel wrapper handed a DTensor refuses it
    from torch.distributed.tensor import Shard, distribute_tensor

    from bigdl_tpu_torch.nn.layers import LayerNorm
    from bigdl_tpu_torch.ops import flash_attention
    from bigdl_tpu_torch.utils.intermediate import FusedLayerNorm

    ln = LayerNorm(16)
    g = torch.Generator().manual_seed(5)      # the same on every rank
    with torch.no_grad():
        ln.weight.normal_(generator=g)
        ln.bias.normal_(generator=g)
    h = torch.as_tensor(np.random.RandomState(4).randn(4, 6, 16),
                        dtype=torch.float32)
    hd = distribute_tensor(h, im.layout.dtensor_mesh,
                           [Shard(0), Shard(2)], src_data_rank=None)
    fused = FusedLayerNorm.from_layernorm(ln)(hd)
    out["fused_ln"] = (fused.full_tensor().detach().numpy(),
                       ln(h).detach().numpy(), str(fused.placements))
    try:
        flash_attention(*(distribute_tensor(torch.zeros(2, 2, 4, 8),
                                            im.layout.dtensor_mesh,
                                            [Shard(0), Shard(1)],
                                            src_data_rank=None)
                          for _ in range(3)))
        out["flash_refused"] = ""
    except TypeError as e:
        out["flash_refused"] = str(e)
    return out


def test_inference_model_layout_serves_as_unsharded(jobs):
    from bigdl_tpu.serving.inference_model import \
        InferenceModel as JInferenceModel
    from bigdl_tpu_torch.serving.inference_model import InferenceModel

    for got in jobs.get("serve"):
        assert got["emb_local"] == (VOCAB // 2, 16)
        for a, b in got["pred"] + [got["pred_resolved"]]:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        laid, plain = got["a37"]["decode"]
        assert [t for t, _ in laid] == [t for t, _ in plain]
        np.testing.assert_allclose([lp for _, lp in laid],
                                   [lp for _, lp in plain], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(*got["a37"]["int8"], rtol=1e-5,
                                   atol=1e-5)
        fused, plain, placements = got["fused_ln"]
        np.testing.assert_allclose(fused, plain, rtol=1e-5, atol=1e-5)
        assert placements == "(Shard(dim=0), Replicate())"
        assert "local_map" in got["flash_refused"]
    with pytest.raises(ValueError) as a:
        InferenceModel(predict_fn=lambda v: v, layout="tp:2")
    with pytest.raises(ValueError) as b:
        JInferenceModel(predict_fn=lambda v: v, layout="tp:2")
    assert str(a.value) == str(b.value)
