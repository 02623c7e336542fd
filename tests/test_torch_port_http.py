"""The port's ``HttpFrontend`` / ``HttpClient``
(``bigdl_tpu_torch.serving.http_frontend``) against the JAX package's.

The HTTP specs of tests/test_obs.py (``/metrics``, request ids),
tests/test_serving.py (round trip, bad requests) and
tests/test_serving_continuous.py (the autoscale policy, keep-alive,
``/models`` and ``/health`` fields), and the fleet specs of tests/test_fleet_chaos.py
(the relay's units, ``resume_from`` re-prefill and adoption, ``/fleet/
import``, ``/fleet/drain`` with a corrupt handoff, mixed page dtypes,
client disconnects) run on the port's modules through
``test_torch_port_obs.PortSpecs`` (collected here under their JAX
names), with the fleet specs' LM the port's
twin of the JAX LM (the same weights through ``utils.convert``).

Across the packages: the same requests get the same status codes and
bodies from a port frontend and a JAX frontend (200 / 400 / 404 / 409 /
413 / 429 / 503 / 504); the JAX ``HttpClient`` against the port's
frontend and the port's client against JAX's give the same predictions
and the same streamed tokens; and a ``/fleet/prefill`` blob from a JAX
frontend is imported by a port frontend's ``/fleet/import`` and resumed
there to the JAX engine's tokens."""

import http.client
import json
import threading
import time
from urllib import request as urlreq
from urllib.error import HTTPError

import jax
import numpy as np
import pytest

from bigdl_tpu.nn.attention import Transformer as JaxTransformer
from bigdl_tpu.serving import decode_engine as jde
from bigdl_tpu.serving import http_frontend as jhttp
from bigdl_tpu.serving import inference_model as jim
from bigdl_tpu.serving import server as jserver
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.serving import decode_engine as pde
from bigdl_tpu_torch.serving import http_frontend as phttp
from bigdl_tpu_torch.serving import inference_model as pim
from bigdl_tpu_torch.serving import server as pserver
from bigdl_tpu_torch.utils import load_jax_params
from test_torch_port_obs import PortSpecs
from test_torch_port_server import PATCH

EOS = 1
FLEET_GEOMETRY = dict(slots=4, page_size=4, pages_per_slot=4,
                      prompt_chunk=4, max_new_tokens=16, eos_id=EOS,
                      prefill_batch=2, prefix_cache_pages=8)


class _LM:
    """The fleet specs' ``lm``: the JAX LM's parameters, and a port LM
    built from them for each engine."""

    def __init__(self):
        self.jmodel = JaxTransformer(vocab_size=32, hidden_size=16,
                                     num_heads=2, num_layers=2,
                                     dropout=0.0, mode="lm")
        v = self.jmodel.init(jax.random.PRNGKey(0),
                             np.arange(6, dtype=np.int32)[None])
        self.v = v
        self.params = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), v["params"])

    def port(self):
        return load_jax_params(Transformer(32, 16, 2, num_layers=2,
                                           dropout=0.0), self.params)


def _engine(lm, **over):
    cfg = pde.DecodeConfig(**dict(FLEET_GEOMETRY, **over))
    return pde.DecodeEngine(pde.LMAdapter(lm.port(), cap=cfg.cap),
                            cfg).warmup()


def _serving_pair(lm, **decode_over):
    im = pim.InferenceModel(lm.port(), device="cpu",
                            decode=pde.DecodeConfig(
                                **dict(FLEET_GEOMETRY, **decode_over)))
    srv = pserver.ServingServer(im, pserver.ServingConfig()).start()
    return srv, phttp.HttpFrontend(srv, port=0).start()


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def lm():
    """The fleet specs' LM: the port's twin of the JAX LM (its own
    module fixtures ``pair``, ``nocache`` and ``drain_pair`` build their
    engines on it through the patched ``_engine`` / ``_serving_pair``)."""
    return _LM()


PortSpecs("test_obs.py").export(globals(), (542, 641))
PortSpecs("test_serving.py", patch=PATCH).export(globals(), (84, 126))
PortSpecs("test_serving_continuous.py", patch=PATCH).export(
    globals(), (367, 479))
# the sentinel (perf-regression gate) is not ported: its import stays
PortSpecs("test_fleet_chaos.py", keep=("obs import sentinel",),
          patch={"_engine": _engine, "_serving_pair": _serving_pair}
          ).export(globals(), (151, 245), (247, 730))


# ---------------------------------------------------------------------------
# status codes and bodies, across the packages


def _slow_double(x):
    time.sleep(0.3)
    return np.asarray(x) * 2.0


def _frontends(pkg):
    """A frontend over two tenants: ``echo`` (doubling) and ``slow`` (a
    0.3 s predict, a queue of one) with a 1 KiB body limit."""
    srv_mod, im_mod, http_mod = pkg
    srv = srv_mod.ServingServer(models={
        "echo": im_mod.InferenceModel(
            predict_fn=lambda x: np.asarray(x) * 2.0),
        "slow": im_mod.InferenceModel(predict_fn=_slow_double)},
        config=srv_mod.ServingConfig(batch_size=1, queue_capacity=1))
    srv.start()
    return srv, http_mod.HttpFrontend(srv, port=0,
                                      max_body_bytes=1024).start()


def _call(fe, path, body=None, headers=None, method="POST"):
    conn = http.client.HTTPConnection(fe.host, fe.port, timeout=30)
    data = body if isinstance(body, (bytes, type(None))) \
        else json.dumps(body).encode()
    conn.request(method, path, body=data,
                 headers=dict({"Content-Type": "application/json"},
                              **(headers or {})))
    resp = conn.getresponse()
    out = (resp.status, resp.read(), resp.getheader("Retry-After"))
    conn.close()
    return out


def _statuses(pkg):
    srv, fe = _frontends(pkg)
    got = {}
    try:
        x = [[1.0, 2.0]]
        got["ok"] = _call(fe, "/predict", {"instances": x, "model": "echo",
                                           "request_id": "r-1"})
        got["bad_json"] = _call(fe, "/predict", b"{not json")
        got["bad_rid"] = _call(fe, "/predict", {"instances": x},
                               {"X-Request-Id": "bad id!"})
        got["bad_model"] = _call(fe, "/predict",
                                 {"instances": x, "model": "a b"})
        got["no_path"] = _call(fe, "/nope", {"instances": x})
        got["no_model"] = _call(fe, "/predict",
                                {"instances": x, "model": "ghost"})
        got["too_big"] = _call(fe, "/predict", {"instances": [[0.0] * 400]})
        got["get_404"] = _call(fe, "/nope", method="GET")
        # the slow tenant: one in predict, one assembled into the next
        # batch, one queued, the next shed; a duplicate of an in-flight
        # id is a retryable 409
        res = {}
        ts = [threading.Thread(target=lambda k=k: res.__setitem__(
            k, _call(fe, "/predict", {"instances": x, "model": "slow",
                                      "request_id": k})))
              for k in ("s-0", "s-1", "s-2")]
        for t in ts:
            t.start()
            time.sleep(0.05)
        got["dup"] = _call(fe, "/predict", {"instances": x, "model": "slow",
                                            "request_id": "s-2"})
        got["shed"] = _call(fe, "/predict",
                            {"instances": x, "model": "slow"})
        for t in ts:
            t.join(30)
        got["slow_ok"] = res["s-0"]
        # an expired deadline is a 504 with the id back
        got["expired"] = _call(fe, "/predict", {
            "instances": x, "model": "slow", "deadline_s": 0.0,
            "request_id": "e-1"})
        # queued when the server stops without a drain: a 503
        t = threading.Thread(target=lambda: res.__setitem__(
            "d-0", _call(fe, "/predict", {"instances": x, "model": "slow",
                                          "request_id": "d-0"})))
        t.start()
        time.sleep(0.1)
        t2 = threading.Thread(target=lambda: res.__setitem__(
            "d-1", _call(fe, "/predict", {"instances": x, "model": "slow",
                                          "request_id": "d-1"})))
        t2.start()
        time.sleep(0.1)
        srv.stop(drain=False)
        t.join(30)
        t2.join(30)
        got["dropped"] = res["d-1"]
    finally:
        fe.stop()
        srv.stop()
    return got


def _shape(status, body, retry):
    """A reply with the parts that vary by run (uuids, times) cut."""
    try:
        doc = json.loads(body)
    except ValueError:
        return status, body, retry
    if "error" in doc:
        doc["error"] = doc["error"].split(" after ")[0][:40]
    return status, doc, retry


def test_status_codes_and_bodies_match_jax_frontend():
    port = _statuses((pserver, pim, phttp))
    jaxs = _statuses((jserver, jim, jhttp))
    want = {"ok": 200, "bad_json": 400, "bad_rid": 400, "bad_model": 400,
            "no_path": 404, "no_model": 404, "too_big": 413,
            "get_404": 404, "dup": 409, "shed": 429, "slow_ok": 200,
            "expired": 504, "dropped": 503}
    assert {k: v[0] for k, v in port.items()} == want
    for k in want:
        assert _shape(*port[k]) == _shape(*jaxs[k]), k


# ---------------------------------------------------------------------------
# clients and blobs across the packages


@pytest.fixture(scope="module")
def lm_frontends(lm):
    geom = dict(FLEET_GEOMETRY, prefix_cache_pages=0)
    psrv = pserver.ServingServer(pim.InferenceModel(
        lm.port(), device="cpu", decode=pde.DecodeConfig(**geom))).start()
    jsrv = jserver.ServingServer(jim.InferenceModel(
        lm.jmodel, lm.v, decode=jde.DecodeConfig(**geom))).start()
    pfe = phttp.HttpFrontend(psrv, port=0).start()
    jfe = jhttp.HttpFrontend(jsrv, port=0).start()
    yield {"port": (psrv, pfe), "jax": (jsrv, jfe)}
    for srv, fe in (psrv, pfe), (jsrv, jfe):
        fe.stop()
        srv.stop()
        srv.model.decode_engine.stop()


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(2, 32, n).astype(np.int32)


def test_clients_cross_the_packages(lm_frontends):
    """JAX's client on the port's frontend and the port's client on
    JAX's: the same generated tokens, streamed or not, greedy or
    seeded, and the same streamed event lines."""
    pfe, jfe = lm_frontends["port"][1], lm_frontends["jax"][1]
    runs = {}
    for name, client in (("jax_on_port", jhttp.HttpClient(pfe.url)),
                         ("port_on_jax", phttp.HttpClient(jfe.url)),
                         ("port_on_port", phttp.HttpClient(pfe.url))):
        out = []
        for n, kw in ((5, {}), (9, dict(temperature=0.8, top_k=8,
                                        top_p=0.9, seed=13))):
            p = _prompt(n, n)
            out.append(client.generate(p, max_new_tokens=7, **kw).tolist())
            out.append([json.dumps(ev, sort_keys=True) for ev in
                        client.generate(p, max_new_tokens=7, stream=True,
                                        **kw)])
        runs[name] = out
    assert runs["jax_on_port"] == runs["port_on_jax"] == runs["port_on_port"]
    assert len(runs["jax_on_port"][0]) == 7


def test_predict_clients_cross_the_packages():
    x = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    outs = []
    for srv_mod, im_mod, http_mod, client_mod in (
            (pserver, pim, phttp, jhttp), (jserver, jim, jhttp, phttp)):
        srv = srv_mod.ServingServer(im_mod.InferenceModel(
            predict_fn=lambda v: np.asarray(v) * 2.0 + 1.0)).start()
        fe = http_mod.HttpFrontend(srv, port=0).start()
        try:
            outs.append(client_mod.HttpClient(fe.url).predict(
                x, request_id="cross-1"))
        finally:
            fe.stop()
            srv.stop()
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0], x * 2 + 1, rtol=1e-6)


def test_jax_prefill_blob_imports_into_port_frontend(lm_frontends):
    """``/fleet/prefill`` on the JAX frontend, its blob through the port
    frontend's ``/fleet/import``, and the resumed stream there: the
    JAX engine's tokens."""
    (psrv, pfe), (jsrv, jfe) = lm_frontends["port"], lm_frontends["jax"]
    p = _prompt(7, 4)
    want = jhttp.HttpClient(jfe.url).generate(p, max_new_tokens=8).tolist()
    req = urlreq.Request(jfe.url + "/fleet/prefill", data=json.dumps(
        {"tokens": p.tolist(), "request_id": "xp-1"}).encode(),
        headers={"Content-Type": "application/json"})
    with urlreq.urlopen(req, timeout=60) as resp:
        blob = resp.read()
    assert resp.headers["Content-Type"] == "application/octet-stream"
    req = urlreq.Request(pfe.url + "/fleet/import", data=blob,
                         headers={"Content-Type":
                                  "application/octet-stream"})
    with urlreq.urlopen(req, timeout=30) as resp:
        assert json.loads(resp.read())["parked"] == "xp-1"
    eng = psrv.model.decode_engine
    before = eng.stats["kv_imports"]
    got = phttp.HttpClient(pfe.url).generate(
        p, max_new_tokens=8, resume_from=want[:1], request_id="xp-1")
    assert got.tolist() == want
    assert eng.stats["kv_imports"] == before + 1
    # a corrupt blob is refused whole
    with pytest.raises(HTTPError) as e:
        urlreq.urlopen(urlreq.Request(
            pfe.url + "/fleet/import", data=blob[:-7],
            headers={"Content-Type": "application/octet-stream"}),
            timeout=30)
    assert e.value.code == 400


class _Recommender:
    """A stand-in for a recommendation pipeline: ``recommend`` is all the
    frontend reads."""

    def recommend(self, user_id, k=10, deadline_s=None, request_id=None):
        if user_id < 0:
            raise KeyError(f"unknown user {user_id}")
        return [(user_id * 10 + i, 1.0 / (i + 1)) for i in range(k)]


def test_recommend_matches_jax_frontend():
    """``/recommend`` over an attached pipeline, a missing one, an unknown
    user and a bad ``k``: the JAX frontend's codes and bodies, and each
    package's ``HttpClient.recommend`` on the other's frontend."""
    got = {}
    for name, srv_mod, im_mod, http_mod, client_mod in (
            ("port", pserver, pim, phttp, jhttp),
            ("jax", jserver, jim, jhttp, phttp)):
        srv = srv_mod.ServingServer(im_mod.InferenceModel(
            predict_fn=lambda v: v)).start()
        fe = http_mod.HttpFrontend(srv, port=0).start()
        try:
            out = [_call(fe, "/recommend", {"user_id": 3})]
            fe.attach_pipeline(_Recommender())
            out += [_call(fe, "/recommend", body) for body in (
                {"user_id": 3, "k": 4}, {"user_id": -1},
                {"user_id": 3, "k": 0})]
            out.append(client_mod.HttpClient(fe.url).recommend(7, k=3))
        finally:
            fe.stop()
            srv.stop()
        got[name] = out
    assert [o[0] for o in got["port"][:4]] == [404, 200, 404, 400]
    assert got["port"] == got["jax"]
    assert got["port"][4] == [(70, 1.0), (71, 0.5), (72, 1.0 / 3)]
