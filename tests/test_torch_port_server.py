"""The port's ``ServingServer`` (``bigdl_tpu_torch.serving.server``)
against the JAX package's.

The specs of tests/test_serving.py (the round trips), of
tests/test_serving_chaos.py (deadlines, shedding, drain, drop, result
GC, degradation and half-open probes) and of
tests/test_serving_continuous.py (continuous against fixed batching,
wakeup, deadline ordering, tenants, weighted admission, register /
unregister, per-tenant metrics, bucketing) run on the port's modules
through ``test_torch_port_obs.PortSpecs``, collected here under their
JAX names.  Where a spec builds a JAX
model, ``model.apply`` stays the JAX forward and ``InferenceModel``
serves the port's twin of it (the same weights through
``utils.convert``), so the spec holds the port's answers to JAX's at
its own tolerance.

Beside them, both packages' servers run one scripted traffic: requests
queued before ``start()`` (so both assemble the same batches), expiry,
shedding, two weighted tenants, a failing tenant's degradation and
fallback, result GC, drain and drop.  Predictions agree within 1e-5;
``stats`` and the ``serving.*`` counters are equal.  On a tiny LM,
``enqueue_generate``, ``prefill_handoff``, a handoff resumed on a second
server, ``park_handoff`` / ``take_parked`` and ``drain_decode`` give the
JAX server's tokens."""

import time

import jax
import numpy as np
import pytest

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn.attention import Transformer as JaxTransformer
from bigdl_tpu.optim import metrics as jmetrics
from bigdl_tpu.serving import decode_engine as jde
from bigdl_tpu.serving import inference_model as jim
from bigdl_tpu.serving import server as jserver
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.optim import metrics
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.serving import decode_engine as pde
from bigdl_tpu_torch.serving import inference_model as pim
from bigdl_tpu_torch.serving import server as pserver
from bigdl_tpu_torch.utils import load_jax_params, load_jax_variables
from test_torch_port_obs import PortSpecs

EOS = 1
GEOMETRY = dict(slots=4, page_size=4, pages_per_slot=4, prompt_chunk=4,
                max_new_tokens=8, eos_id=EOS, prefill_batch=2)


class _Both:
    """A JAX model and its port twin on the same weights: a spec's
    ``model.apply(v, x)`` runs the JAX forward, and ``InferenceModel``
    (:func:`_port_im`) serves the twin."""

    def __init__(self, jmodel, port):
        self.jmodel, self.port = jmodel, port

    def apply(self, v, x):
        return self.jmodel.apply(v, x)


def _model_and_vars(din=4, dout=2, seed=0):
    jm = jnn.Sequential([jnn.Linear(din, 8), jnn.ReLU(),
                         jnn.Linear(8, dout)])
    v = jm.init(jax.random.PRNGKey(seed), np.zeros((1, din), np.float32))
    port = nn.Sequential([nn.Linear(din, 8), nn.ReLU(), nn.Linear(8, dout)])
    return _Both(jm, load_jax_variables(port, v)), v


def _port_im(model=None, variables=None, **kw):
    """The JAX ``InferenceModel(model, variables, ...)`` surface on the
    port: the twin of a :class:`_Both`, served on the CPU."""
    if isinstance(model, _Both):
        model = model.port
    return pim.InferenceModel(model, device="cpu", **kw)


PATCH = {"_model_and_vars": _model_and_vars, "InferenceModel": _port_im}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


PortSpecs("test_serving.py", patch=PATCH).export(globals(), (41, 83))
PortSpecs("test_serving_chaos.py").export(globals(), (53, 380))
# the JAX recompile sentinel's spec: its port counterpart is
# test_mixed_size_sweep_sees_only_bucket_shapes
PortSpecs("test_serving_continuous.py", patch=PATCH).export(
    globals(), (47, 365),
    skip=("test_mixed_size_sweep_zero_unexpected_recompiles",))


def test_mixed_size_sweep_sees_only_bucket_shapes():
    """The port's form of the zero-recompile sweep: across requests of 1
    to 20 rows the served model only ever sees the bucket shapes."""
    both, _ = _model_and_vars()
    im = _port_im(both, batch_buckets=(2, 4, 8))
    seen = []
    im.model.register_forward_pre_hook(
        lambda m, a: seen.append(a[0].shape[0]))
    srv = pserver.ServingServer(im, pserver.ServingConfig(
        batch_size=4, batch_timeout_s=0.001)).start()
    try:
        rs = np.random.RandomState(0)
        for rows in (1, 2, 3, 5, 7, 8, 9, 20):
            rid = srv.enqueue(rs.rand(rows, 4).astype(np.float32))
            assert srv.query(rid, timeout=30).shape == (rows, 2)
    finally:
        srv.stop()
    assert set(seen) <= {2, 4, 8}


# ---------------------------------------------------------------------------
# one scripted traffic through both packages' servers


def _fail_first(n):
    calls = [0]

    def predict(x):
        calls[0] += 1
        if calls[0] <= n:
            raise RuntimeError("replica down")
        return np.asarray(x) * 3.0
    return predict


def _scripted(pkg, model):
    """Run the script on ``pkg``'s server; return the answers (or the
    error class name) by request, ``stats`` and the ``serving.*``
    counters."""
    srv_mod, mod, im_mod = pkg
    reg = mod.Metrics()
    m = (model.port if srv_mod is pserver else model.jmodel)
    im = (pim.InferenceModel(m, device="cpu", batch_buckets=(2, 4))
          if srv_mod is pserver else
          im_mod.InferenceModel(m, VARS, batch_buckets=(2, 4)))
    im.warmup(np.zeros((1, 4), np.float32))   # JAX compiles here
    cfg = srv_mod.ServingConfig(batch_size=4, queue_capacity=6,
                                batch_timeout_s=0.002, result_ttl_s=1.5,
                                result_gc_interval_s=0.05,
                                degraded_after_failures=1,
                                degraded_probe_interval_s=0.05)
    srv = srv_mod.ServingServer(models={
        "m": im, "echo": im_mod.InferenceModel(
            predict_fn=lambda x: np.asarray(x) * 2.0)},
        config=cfg, metrics=reg)
    srv.register_model("flaky", im_mod.InferenceModel(
        predict_fn=_fail_first(1)), weight=2.0)
    rs = np.random.RandomState(3)
    out, rids = {}, []

    def put(tag, x, **kw):
        try:
            rids.append((tag, srv.enqueue(x, request_id=tag, **kw)))
        except Exception as e:  # noqa: BLE001 — the verdict is the result
            out[tag] = type(e).__name__

    # queued before start: both servers assemble the same batches
    for i in range(7):          # the 7th is over queue_capacity: shed
        put(f"m{i}", rs.rand(1 + i % 3, 4).astype(np.float32), model="m")
    put("late", rs.rand(1, 4).astype(np.float32), model="echo",
        deadline_s=0.0)         # expires before predict
    for i in range(3):
        put(f"e{i}", rs.rand(2, 4).astype(np.float32), model="echo")
    put("f0", np.ones((1, 4), np.float32), model="flaky")
    srv.start()
    for tag, rid in rids:
        try:
            out[tag] = srv.query(rid, timeout=30)
        except Exception as e:  # noqa: BLE001
            out[tag] = type(e).__name__
    # degraded with no fallback: shed until the half-open probe heals it
    put("f1", np.ones((1, 4), np.float32), model="flaky")
    time.sleep(0.06)
    put("f2", np.ones((1, 4), np.float32), model="flaky")
    for tag in ("f2",):
        out[tag] = srv.query(tag, timeout=30)
    # a result never queried is collected after its TTL
    srv.enqueue(np.ones((1, 4), np.float32), request_id="gc", model="echo")
    time.sleep(1.7)
    srv.enqueue(np.ones((1, 4), np.float32), request_id="g2", model="echo")
    out["g2"] = srv.query("g2", timeout=30)
    srv.unregister_model("echo")
    put("gone", np.ones((1, 4), np.float32), model="echo")
    srv.stop(drain=True, timeout=10)
    put("after", np.ones((1, 4), np.float32), model="m")
    counters = {k: v for k, v in reg.snapshot()["counters"].items()
                if k.startswith("serving.")}
    return out, dict(srv.stats), counters


VARS = None


def test_scripted_traffic_matches_jax_server():
    global VARS
    both, VARS = _model_and_vars(seed=1)
    port = _scripted((pserver, metrics, pim), both)
    jaxs = _scripted((jserver, jmetrics, jim), both)
    assert port[0].keys() == jaxs[0].keys()
    for tag, a in port[0].items():
        b = jaxs[0][tag]
        if isinstance(b, str):
            assert a == b, tag
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=tag)
    assert port[1] == jaxs[1]
    assert port[2] == jaxs[2]
    assert port[1]["shed_requests"] >= 2 and port[1]["results_gc"] >= 1
    assert port[1]["expired_requests"] == 1


# ---------------------------------------------------------------------------
# the LM tenant: generate, the prefill handoff, parking and draining


@pytest.fixture(scope="module")
def lm_servers():
    jm = JaxTransformer(vocab_size=32, hidden_size=16, num_heads=2,
                        num_layers=2, dropout=0.0, mode="lm")
    v = jm.init(jax.random.PRNGKey(0), np.arange(6, dtype=np.int32)[None])
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    v["params"])
    made = []
    for _ in range(2):
        pm = load_jax_params(Transformer(32, 16, 2, num_layers=2,
                                         dropout=0.0), params)
        made.append({
            "port": pserver.ServingServer(pim.InferenceModel(
                pm, decode=pde.DecodeConfig(**GEOMETRY), device="cpu")
            ).start(),
            "jax": jserver.ServingServer(jim.InferenceModel(
                jm, v, decode=jde.DecodeConfig(**GEOMETRY))).start()})
    yield made
    for pair in made:
        for srv in pair.values():
            srv.stop()
            srv.model.decode_engine.stop()


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(2, 32, n).astype(np.int32)


def test_lm_generate_handoff_park_drain_match_jax(lm_servers):
    got = {}
    for pkg in ("port", "jax"):
        a, b = lm_servers[0][pkg], lm_servers[1][pkg]
        streamed = []
        rids = [a.enqueue_generate(_prompt(n, n), max_new_tokens=6,
                                   request_id=f"{pkg}-g{n}",
                                   on_token=(lambda rid, t, i:
                                             streamed.append(t))
                                   if n == 5 else None)
                for n in (3, 5, 9)]
        toks = [list(map(int, a.query(r, timeout=60))) for r in rids]
        seeded = a.enqueue_generate(_prompt(6, 1), max_new_tokens=6,
                                    temperature=0.8, top_k=8, top_p=0.9,
                                    seed=13)
        toks.append(list(map(int, a.query(seeded, timeout=60))))
        # the prefill half on one server, the decode half on another
        h = a.prefill_handoff(_prompt(7, 2), request_id=f"{pkg}-h")
        resumed = b.enqueue_generate(handoff=h, max_new_tokens=6)
        toks.append([int(h["first_token"])]
                    + list(map(int, b.query(resumed, timeout=60)))[1:])
        # a parked handoff is taken once
        park = dict(h, request_id=f"{pkg}-parked")
        assert b.park_handoff(park) == f"{pkg}-parked"
        assert b.take_parked(f"{pkg}-parked") is park
        assert b.take_parked(f"{pkg}-parked") is None
        # nothing live: a drain ships nothing
        drained = b.drain_decode(peers=[], timeout=5.0)
        got[pkg] = (toks, streamed, h["tokens"].tolist(), drained)
    port, jaxs = got["port"], got["jax"]
    assert port[0] == jaxs[0]
    assert port[1] == port[0][1] == jaxs[1]
    assert port[2] == jaxs[2]
    assert port[3] == jaxs[3]
    # the handoff resumed elsewhere gives the tokens of a whole generate
    whole = lm_servers[0]["port"].enqueue_generate(_prompt(7, 2),
                                                    max_new_tokens=6)
    assert list(map(int, lm_servers[0]["port"].query(whole, timeout=60))) \
        == port[0][4]


# ---------------------------------------------------------------------------
# InferenceModel(predict_fn=), load, PredictionService; the tenant's trace


def test_load_and_prediction_service_match_jax(tmp_path):
    """A model saved by the JAX package's ``save_model`` served through
    the port's ``InferenceModel.load``, and ``PredictionService`` over it
    and over a callable: the JAX package's answers within 1e-5, its
    errors returned, not raised; ``load_tf`` / ``load_caffe`` name
    A.6.11."""
    from bigdl_tpu.optim.prediction_service import \
        PredictionService as JService
    from bigdl_tpu.utils.serializer import save_model
    from bigdl_tpu_torch.optim.prediction_service import PredictionService

    both, v = _model_and_vars(seed=2)
    save_model(str(tmp_path / "m"), both.jmodel, v)
    x = np.random.RandomState(5).rand(6, 4).astype(np.float32)
    want = np.asarray(both.jmodel.apply(v, x)[0])
    port = nn.Sequential([nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2)])
    im = pim.InferenceModel.load(str(tmp_path / "m"), port, device="cpu")
    np.testing.assert_allclose(im.predict(x), want, rtol=1e-5, atol=1e-6)
    svc = PredictionService(im, n_replicas=2)
    np.testing.assert_allclose(svc.predict(x), want, rtol=1e-5, atol=1e-6)
    jsvc = JService(predict_fn=lambda a: np.asarray(a) * 2.0)
    psvc = PredictionService(predict_fn=lambda a: np.asarray(a) * 2.0)
    np.testing.assert_array_equal(psvc.predict(x), jsvc.predict(x))
    bad = PredictionService(predict_fn=lambda a: 1 / 0)
    out, err = bad.try_predict(x)
    assert out is None and isinstance(err, ZeroDivisionError)
    for loader in (pim.InferenceModel.load_tf,
                   pim.InferenceModel.load_caffe):
        with pytest.raises(NotImplementedError, match="A.6.11"):
            loader(str(tmp_path / "m"))
    with pytest.raises(ValueError) as a:
        pim.InferenceModel(predict_fn=lambda a: a, weight_quant="int8")
    with pytest.raises(ValueError) as b:
        jim.InferenceModel(predict_fn=lambda a: a, weight_quant="int8")
    assert str(a.value) == str(b.value)


def test_tenant_reaches_the_admission_event(lm_servers):
    """A generate request's tenant rides ``DecodeRequest.tenant`` into
    the ``decode/admission`` event, as in the JAX engine; both engines
    emit the same event names for the same request."""
    from bigdl_tpu.obs import trace as jtrace
    from bigdl_tpu_torch.obs import trace as ptrace

    names = {}
    for pkg, tr in (("port", ptrace), ("jax", jtrace)):
        t = tr.enable()
        try:
            srv = lm_servers[0][pkg]
            srv.register_model("acme", srv.model)
            try:
                rid = srv.enqueue_generate(_prompt(6, 9), model="acme",
                                           max_new_tokens=3,
                                           request_id=f"{pkg}-tenant")
                srv.query(rid, timeout=60)
            finally:
                srv.unregister_model("acme")
        finally:
            tr.disable()
        events = [s for s in t.spans()
                  if s.attrs.get("request_id") == f"{pkg}-tenant"]
        adm = [s for s in events if s.name == "decode/admission"]
        assert adm and adm[0].attrs["tenant"] == "acme", pkg
        names[pkg] = sorted({s.name for s in events})
    assert names["port"] == names["jax"]
    assert "decode/prefill_chunk" in names["port"]
