"""The port's HTTP serving layer (``ultra_tpu_torch/server.py``) on a CPU
predictor: the endpoints answer over a live socket and agree with direct
calls of the predictor and the executor; malformed input gets 400, not
500; and, against the JAX package's service on the same weights and graph,
the same answers, and 400 for the two requests the JAX package answers
(``ADVICE.md``: a boolean id, a one-branch intersection).

Tolerances: scores and probabilities as served (rounded to 6 places)
within 1e-4 relative and 1e-5 absolute of the direct call's; against the
JAX package, probabilities within 2e-5 absolute (the executors' parity
bound, ``tests/test_torch_query.py``) and ids equal where no other
candidate lies within 1e-4.
"""

import concurrent.futures
import json
import threading
from http.client import HTTPConnection

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_query import configs
from ultra_tpu.data.synthetic import synthetic_graph
from ultra_tpu.serve import UltraPredictor as JUltraPredictor
from ultra_tpu.server import PredictionService as JPredictionService
from ultra_tpu.train.loop import init_ultra_params as jax_init_ultra_params
from ultra_tpu_torch.data.kg import KGSplit, split_to_graph
from ultra_tpu_torch.models.nbfnet import Ultra
from ultra_tpu_torch.query import ops as qops
from ultra_tpu_torch.serve import UltraPredictor
from ultra_tpu_torch.server import PredictionService, make_http_server
from ultra_tpu_torch.utils.torch_ckpt import params_from_jax

V, R_DIRECT = 30, 4
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def built():
    """(port service, JAX params, JAX config, the JAX graph)."""
    jgraph, ei, et = synthetic_graph(num_nodes=V, num_direct_rel=R_DIRECT, num_triples=120,
                                     seed=1)
    jcfg, pcfg = configs()
    params = jax.device_get(jax_init_ultra_params(jcfg, jax.random.key(0)))
    model = Ultra(pcfg)
    model.load_state_dict(params_from_jax(params))
    graph = split_to_graph(KGSplit(ei, et, V, 2 * R_DIRECT, ei[:, :0], et[:0]), device="cpu")
    pred = UltraPredictor(model, graph, batch_size=4, device="cpu")
    service = PredictionService(pred, entity_names=[f"ent{i}" for i in range(V)])
    return service, params, jcfg, jgraph


@pytest.fixture(scope="module")
def service(built):
    return built[0]


@pytest.fixture(scope="module")
def jax_service(built):
    _, params, jcfg, jgraph = built
    return JPredictionService(JUltraPredictor(params, jcfg, jgraph, batch_size=4))


@pytest.fixture(scope="module")
def server(service):
    httpd = make_http_server(service, port=0)  # a free port
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd.server_address
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


def _req(addr, method, path, payload=None):
    conn = HTTPConnection(*addr, timeout=120)
    body = json.dumps(payload) if payload is not None else None
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def direct_probs(service, nested_queries):
    """(B, V) answer probabilities of the executor, called directly."""
    progs = [qops.from_nested(q) for q in nested_queries]
    kind, operand = qops.decompose(qops.pad_queries(progs, max(map(len, progs))))
    fwd, rel_reprs = service._query_forward()
    return torch.sigmoid(fwd(service.predictor.graph, kind, operand, rel_reprs).double()).numpy()


def test_healthz_and_meta(server):
    assert _req(server, "GET", "/healthz") == (200, {"status": "ok"})
    status, out = _req(server, "GET", "/v1/meta")
    assert status == 200
    assert out["num_entities"] == V and out["num_relations_direct"] == R_DIRECT
    assert out["batch_size"] == 4 and out["has_entity_names"]


def test_predict_matches_direct_call(server, service):
    status, out = _req(server, "POST", "/v1/predict", {"queries": [
        {"head": 0, "relation": 1, "k": 5},
        {"head": 5, "relation": 3, "k": 3, "mode": "head"},
    ]})
    assert status == 200, out
    res = out["results"]
    assert len(res[0]["entities"]) == 5 and len(res[1]["entities"]) == 3
    s_t, i_t = service.predictor.predict_tails([0], [1], k=5)
    np.testing.assert_array_equal(res[0]["entities"], i_t[0])
    np.testing.assert_allclose(res[0]["scores"], s_t[0], **TOL)
    assert res[0]["entity_names"][0] == f"ent{i_t[0, 0]}"
    s_h, i_h = service.predictor.predict_heads([5], [3], k=3)  # the inverse relation
    np.testing.assert_array_equal(res[1]["entities"], i_h[0])
    np.testing.assert_allclose(res[1]["scores"], s_h[0], **TOL)


def test_query_endpoint_matches_the_executor(server, service):
    nested = [((3, (1,)), (7, (2,))), (0, (1, 3)), ((4, (0,)), (6, (5, -2)))]  # 2i, 2p, 2in
    status, out = _req(server, "POST", "/v1/query", {
        "queries": [json.loads(json.dumps(q)) for q in nested], "k": 4})
    assert status == 200, out
    prob = direct_probs(service, nested)
    for i, res in enumerate(out["results"]):
        assert len(res["entities"]) == 4
        assert res["probs"] == sorted(res["probs"], reverse=True)
        np.testing.assert_allclose(res["probs"], prob[i][res["entities"]], **TOL)
        order = np.argsort(-prob[i], kind="stable")[:4]
        np.testing.assert_allclose(res["probs"], prob[i][order], **TOL)


def test_query_matches_the_jax_service(service, jax_service):
    """Both packages' services on one payload (14 BetaE types would need
    more ids than this graph: a mix of 6 types)."""
    payload = {"queries": [[3, [1]], [0, [1, 3]], [[3, [1]], [7, [2]]],
                           [[4, [0]], [6, [5, -2]]], [[1, [2]], [2, [3]], [-1]],
                           [[[5, [0]], [8, [1]]], [2]]], "k": 5}
    got, want = service.query(payload), jax_service.query(payload)
    for g, w in zip(got["results"], want["results"]):
        np.testing.assert_allclose(g["probs"], w["probs"], rtol=0, atol=2e-5)
        gap = np.abs(np.diff(w["probs"]))
        distinct = np.concatenate([[True], gap > 1e-4]) & np.concatenate([gap > 1e-4, [True]])
        np.testing.assert_array_equal(np.array(g["entities"])[distinct],
                                      np.array(w["entities"])[distinct])


def test_error_paths(server):
    cases = [
        ("/v1/predict", {"queries": []}, "non-empty"),
        ("/v1/predict", {"queries": [{"head": 99, "relation": 0}]}, "out of range"),
        ("/v1/predict", {"queries": [{"head": 0, "relation": 7}]}, "relation"),
        ("/v1/predict", {"queries": [{"head": 0}]}, "'relation'"),
        ("/v1/predict", {"queries": [{"head": 0, "relation": 1, "k": "five"}]}, "'k'"),
        ("/v1/predict", {"queries": [{"head": 0, "relation": 1, "k": -3}]}, "'k'"),
        ("/v1/predict", {"queries": [{"head": 0, "relation": 1, "mode": "both"}]}, "mode"),
        ("/v1/predict", {"queries": [{"head": 0, "relation": 1}] * 65}, "max 64"),
        ("/v1/query", {"queries": ["nope"]}, "BetaE"),
        ("/v1/query", {"queries": [[99999, [1]]]}, "entity id"),
        ("/v1/query", {"queries": [[0, [8]]]}, "relation id"),
        ("/v1/query", {"queries": [[0, [-5]]]}, "2**31"),
        ("/v1/query", {"queries": [[0, [1] * 40]]}, "too long"),
        ("/v1/query", {"queries": [[0, []]]}, "not a BetaE"),
        ("/v1/query", {"queries": [[0, [1]]], "k": 0}, "'k'"),
    ]
    for path, payload, words in cases:
        status, out = _req(server, "POST", path, payload)
        assert status == 400 and words in out["error"], (path, payload, status, out)
    assert _req(server, "GET", "/v1/nope")[0] == 404
    assert _req(server, "POST", "/v1/nope", {})[0] == 404
    conn = HTTPConnection(*server, timeout=60)
    conn.request("POST", "/v1/query", body="{not json")
    resp = conn.getresponse()
    assert resp.status == 400 and "bad JSON" in json.loads(resp.read())["error"]
    conn.close()


def test_meta_counts_requests(server):
    _, before = _req(server, "GET", "/v1/meta")
    _req(server, "POST", "/v1/predict", {"queries": [{"head": 1, "relation": 0}]})
    _, after = _req(server, "GET", "/v1/meta")
    assert after["requests"] == before["requests"] + 1
    assert after["latency_ms"]["p50"] is not None


def test_concurrent_requests_no_errors(server):
    """Handlers run in threads: predict, query and meta at once all answer
    200 (the lock serialises the device work and the statistics)."""

    def one(i):
        kind = i % 3
        if kind == 0:
            return _req(server, "POST", "/v1/predict",
                        {"queries": [{"head": i % V, "relation": i % 4, "k": 5}]})[0]
        if kind == 1:
            return _req(server, "POST", "/v1/query",
                        {"queries": [[i % V, [i % 8]]], "k": 3})[0]
        return _req(server, "GET", "/v1/meta")[0]

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        statuses = list(ex.map(one, range(24)))
    assert statuses == [200] * 24, statuses


def test_validation_edge_cases(server):
    # a body that is not a JSON object -> 400, not 500
    status, out = _req(server, "POST", "/v1/predict", [1, 2])
    assert status == 400 and "JSON object" in out["error"]
    assert _req(server, "POST", "/v1/query", [1, 2])[0] == 400
    # ids that would wrap in int32 or alias opcode bits -> 400
    status, out = _req(server, "POST", "/v1/query", {"queries": [[2**32 + 5, [1]]]})
    assert status == 400 and "2**31" in out["error"]
    assert _req(server, "POST", "/v1/query", {"queries": [[0, [2**58 + 1]]]})[0] == 400
    # k above the graph's size is clamped to it
    status, out = _req(server, "POST", "/v1/predict",
                       {"queries": [{"head": 0, "relation": 1, "k": 100}]})
    assert status == 200 and len(out["results"][0]["entities"]) == V
    status, out = _req(server, "POST", "/v1/query", {"queries": [[0, [1]]], "k": 100})
    assert status == 200 and len(out["results"][0]["entities"]) == V


@pytest.mark.parametrize("path, payload", [
    ("/v1/predict", {"queries": [{"head": True, "relation": 1}]}),
    ("/v1/predict", {"queries": [{"head": 0, "relation": True}]}),
    ("/v1/predict", {"queries": [{"head": 0, "relation": 1, "k": True}]}),
    ("/v1/query", {"queries": [[True, [1]]]}),
    ("/v1/query", {"queries": [[0, [True]]]}),
    ("/v1/query", {"queries": [[[3, [1]]]]}),  # an intersection of one branch
    ("/v1/query", {"queries": [[[[3, [1]]], [2]]]}),  # the same under a projection
])
def test_advice_divergences_get_400_where_jax_answers(server, jax_service, path, payload):
    """ADVICE.md: the JAX package answers a boolean id as 0 or 1 and a
    one-branch intersection as its branch; the port refuses both."""
    status, out = _req(server, "POST", path, payload)
    assert status == 400, out
    assert "boolean" in out["error"] or "branch" in out["error"] or "2**31" in out["error"]
    call = jax_service.predict if path == "/v1/predict" else jax_service.query
    assert len(call(json.loads(json.dumps(payload)))["results"]) == 1  # JAX answers
