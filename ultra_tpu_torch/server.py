"""HTTP serving front end: link prediction and complex queries over one
:class:`~ultra_tpu_torch.serve.UltraPredictor`.

Counterpart of ``ultra_tpu/server.py`` (the standard library only): a
``ThreadingHTTPServer`` whose handlers run their device work under one lock
(one card runs one program at a time, and serialising keeps tail latency
predictable). Endpoints:

  GET  /healthz      -> {"status": "ok"}
  GET  /v1/meta      -> graph and model sizes, request count, latency p50/p90/p99
  POST /v1/predict   -> {"queries": [{"head": id, "relation": id,
                         "mode": "tail"|"head", "k": 10}]}
                        mode "head" scores through the inverse relation
                        (base_nbfnet.py:79-86)
  POST /v1/query     -> {"queries": [<BetaE nested list>], "k": 10}
                        e.g. [[3, [1]], [7, [2]]] = 2i; -2 = negation;
                        compiled by query/ops.py::from_nested and answered
                        zero-shot by the round-grouped executor

The JAX package pads k, the query batch and the program length to buckets
to keep its compiled programs few; the port runs eagerly and pads nothing
but the programs of one request to their longest. It answers two requests
with 400 that the JAX package answers (``ADVICE.md``): a JSON boolean given
as an id, a k or an entity or relation of a query, and an intersection or
union of fewer than two branches.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np
import torch

from ultra_tpu_torch.query import ops as qops


class BadRequest(ValueError):
    pass


def _as_tuples(nested):
    """JSON lists -> the tuples query/ops.from_nested expects."""
    if isinstance(nested, list):
        return tuple(_as_tuples(v) for v in nested)
    return nested


def _int_field(raw, what: str) -> int:
    """An integer id or count from a request; a JSON boolean is refused (it
    is an int to Python)."""
    if isinstance(raw, bool):
        raise BadRequest(f"{what} must be an integer, not a boolean")
    try:
        return int(raw)
    except (TypeError, ValueError):
        raise BadRequest(f"{what} must be an integer") from None


def _check_branches(nested) -> None:
    """Raises ValueError where an intersection or union of the nested query
    has fewer than two branches: ``from_nested`` would drop the operator
    and answer the one branch alone."""
    if len(nested) == 2 and isinstance(nested[-1][-1], int):  # (var, unary ops)
        if isinstance(nested[0], tuple):
            _check_branches(nested[0])
        return
    branches = nested if len(nested[-1]) > 1 else nested[:-1]
    if len(branches) < 2:
        raise ValueError(f"an intersection or union needs two branches, got {len(branches)}")
    for branch in branches:
        _check_branches(branch)


class PredictionService:
    """The endpoints' work without the transport (usable directly in tests)."""

    def __init__(
        self,
        predictor,
        qcfg=None,
        entity_names: Optional[Sequence[str]] = None,
        max_batch: int = 64,
        max_query_len: int = 16,
    ):
        self.predictor = predictor
        self.entity_names = list(entity_names) if entity_names else None
        self.max_batch = max_batch
        self.max_query_len = max_query_len
        self._lock = threading.Lock()
        self._latencies = deque(maxlen=4096)
        self._requests = 0
        self._started = time.time()
        self._qfwd = None
        self._qcfg = qcfg

    def _parse_k(self, raw, where: str) -> int:
        k = _int_field(raw, f"{where}: 'k'")
        if k < 1:
            raise BadRequest(f"{where}: 'k' must be >= 1")
        return min(k, self.predictor.graph.num_nodes)

    @staticmethod
    def _payload_dict(payload) -> dict:
        if not isinstance(payload, dict):
            raise BadRequest("body must be a JSON object")
        return payload

    def _queries(self, payload) -> list:
        queries = self._payload_dict(payload).get("queries")
        if not isinstance(queries, list) or not queries:
            raise BadRequest("body must be {'queries': [..]} (non-empty)")
        if len(queries) > self.max_batch:
            raise BadRequest(f"max {self.max_batch} queries per request")
        return queries

    def _record(self, dt_ms: float) -> None:
        with self._lock:
            self._latencies.append(dt_ms)
            self._requests += 1

    def _named(self, res: dict, ent: list) -> dict:
        if self.entity_names:
            res["entity_names"] = [self.entity_names[e] for e in ent]
        return res

    # -- link prediction ---------------------------------------------------

    def predict(self, payload: dict) -> dict:
        queries = self._queries(payload)
        num_direct = self.predictor.graph.num_relations // 2
        v = self.predictor.graph.num_nodes
        h, r, ks = [], [], []
        for i, q in enumerate(queries):
            if not isinstance(q, dict) or "head" not in q or "relation" not in q:
                raise BadRequest(f"query {i}: need integer 'head' and 'relation'")
            head = _int_field(q["head"], f"query {i}: 'head'")
            rel = _int_field(q["relation"], f"query {i}: 'relation'")
            mode = q.get("mode", "tail")
            if mode not in ("tail", "head"):
                raise BadRequest(f"query {i}: mode must be 'tail' or 'head'")
            if not 0 <= head < v:
                raise BadRequest(f"query {i}: head {head} out of range [0, {v})")
            if not 0 <= rel < num_direct:
                raise BadRequest(
                    f"query {i}: relation {rel} out of range [0, {num_direct}) "
                    "(direct relations; head-mode adds the inverse internally)"
                )
            h.append(head)
            r.append(rel + num_direct if mode == "head" else rel)
            ks.append(self._parse_k(q.get("k", 10), f"query {i}"))
        t0 = time.perf_counter()
        with self._lock:
            scores, tails = self.predictor.predict_tails(h, r, k=max(ks))
        dt = (time.perf_counter() - t0) * 1e3
        self._record(dt)
        results = []
        for i, ki in enumerate(ks):
            ent = tails[i, :ki].tolist()
            results.append(self._named(
                {"entities": ent, "scores": [round(float(s), 6) for s in scores[i, :ki]]},
                ent))
        return {"results": results, "latency_ms": round(dt, 2)}

    # -- complex queries ---------------------------------------------------

    def _query_forward(self):
        """(forward, relation outputs), made once, under the lock: two first
        queries at once must not make two, nor run the precompute beside
        other device work."""
        with self._lock:
            if self._qfwd is None:
                from ultra_tpu_torch.query.executor import QueryConfig
                from ultra_tpu_torch.query.trainer import make_query_forward_grouped

                qcfg = self._qcfg or QueryConfig(dropout_ratio=0.0, threshold=0.8)
                self._qfwd = (make_query_forward_grouped(self.predictor.model, qcfg),
                              self.predictor.rel_reprs)
            return self._qfwd

    @staticmethod
    def _raw_ids_ok(nested) -> bool:
        """Every id of the nested query is an int (not a boolean) in [-2,
        2**31): a negative id other than the -2 negation marker corrupts the
        opcode bits (query/ops.py), an id >= 2**31 wraps in decompose's
        int32 operand, and one >= 2**58 aliases an opcode; all three would
        slip past the range checks on the decoded program."""
        if isinstance(nested, tuple):
            return all(PredictionService._raw_ids_ok(x) for x in nested)
        return type(nested) is int and -2 <= nested < 2**31

    def _program(self, i: int, q) -> np.ndarray:
        """The checked program of query ``i``."""
        if not isinstance(q, list):
            raise BadRequest(f"query {i}: must be a BetaE nested list")
        nested = _as_tuples(q)
        if not self._raw_ids_ok(nested):
            raise BadRequest(
                f"query {i}: ids must be ints in [0, 2**31) "
                "(-2 = negation marker inside a unary-op list)"
            )
        try:
            _check_branches(nested)
            prog = qops.from_nested(nested)
        except Exception as exc:  # noqa: BLE001 - any malformed nesting is the client's
            raise BadRequest(f"query {i}: not a BetaE nested query ({exc})") from None
        # the decoded operands: an out-of-range id would index past a table
        if (prog < 0).any():
            raise BadRequest(
                f"query {i}: negative ids are invalid (-2 is only "
                "valid inside a unary-op list, meaning negation)"
            )
        kind, operand = qops.decompose(prog[None, :])
        v = self.predictor.graph.num_nodes
        num_rel = self.predictor.graph.num_relations  # inverses included (BetaE)
        ents, rels = operand[kind == qops.K_OPERAND], operand[kind == qops.K_PROJECTION]
        if ents.size and (ents.min() < 0 or ents.max() >= v):
            raise BadRequest(f"query {i}: entity id out of range [0, {v})")
        if rels.size and (rels.min() < 0 or rels.max() >= num_rel):
            raise BadRequest(f"query {i}: relation id out of range [0, {num_rel})")
        if len(prog) > self.max_query_len:
            raise BadRequest(f"query too long ({len(prog)} ops; max {self.max_query_len})")
        return prog

    def query(self, payload: dict) -> dict:
        queries = self._queries(payload)
        k = self._parse_k(payload.get("k", 10), "body")
        progs = [self._program(i, q) for i, q in enumerate(queries)]
        kind, operand = qops.decompose(qops.pad_queries(progs, max(map(len, progs))))
        fwd, rel_reprs = self._query_forward()
        t0 = time.perf_counter()
        with self._lock:
            prob = torch.sigmoid(fwd(self.predictor.graph, kind, operand, rel_reprs).double())
            top_p, top_i = torch.topk(prob, k, dim=-1)
            top_p, top_i = top_p.cpu().numpy(), top_i.cpu().numpy()
        dt = (time.perf_counter() - t0) * 1e3
        self._record(dt)
        # the executor's last stack value is a logit (sigmoid-BCE training,
        # query/trainer.py); an answer's probability is its sigmoid
        results = []
        for i in range(len(queries)):
            ent = top_i[i].tolist()
            results.append(self._named(
                {"entities": ent, "probs": [round(float(p), 6) for p in top_p[i]]}, ent))
        return {"results": results, "latency_ms": round(dt, 2)}

    # -- meta --------------------------------------------------------------

    def meta(self) -> dict:
        with self._lock:  # _latencies mutates on request threads
            lat = sorted(self._latencies)
            requests = self._requests
        pct = lambda p: round(lat[int(p * (len(lat) - 1))], 2) if lat else None  # noqa: E731
        g = self.predictor.graph
        return {
            "num_entities": int(g.num_nodes),
            "num_relations_direct": int(g.num_relations // 2),
            "batch_size": self.predictor.batch_size,
            "requests": requests,
            "uptime_s": round(time.time() - self._started, 1),
            "latency_ms": {"p50": pct(0.5), "p90": pct(0.9), "p99": pct(0.99)},
            "has_entity_names": bool(self.entity_names),
        }


def make_http_server(service: PredictionService, host: str = "127.0.0.1",
                     port: int = 8080) -> ThreadingHTTPServer:
    """Bind (port 0 picks a free one; ``.server_address`` has the result)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # no line on stderr per request
            pass

        def _send(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            try:
                if self.path == "/healthz":
                    self._send(200, {"status": "ok"})
                elif self.path == "/v1/meta":
                    self._send(200, service.meta())
                else:
                    self._send(404, {"error": f"no route {self.path}"})
            except Exception as exc:  # noqa: BLE001 - the server keeps running
                self._send(500, {"error": f"{type(exc).__name__}: {exc}"})

        def do_POST(self):
            routes = {"/v1/predict": service.predict, "/v1/query": service.query}
            fn = routes.get(self.path)
            if fn is None:
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                self._send(200, fn(payload))
            except BadRequest as exc:
                self._send(400, {"error": str(exc)})
            except json.JSONDecodeError as exc:
                self._send(400, {"error": f"bad JSON: {exc}"})
            except Exception as exc:  # noqa: BLE001 - the server keeps running
                self._send(500, {"error": f"{type(exc).__name__}: {exc}"})

    return ThreadingHTTPServer((host, port), Handler)
