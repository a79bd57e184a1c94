"""rad_tpu_torch's HTTP server and remote client against rad_tpu's.

The cases of ``tests/test_remote.py`` run against the port over loopback
(a real server, the client's health, top-level nodes, neighbors and info,
connection failures, auth, static files, a remote traversal and a scoring
worker joining over HTTP); every route's status and JSON body compared
between the port's server and rad_tpu's on the same graph; and the two
packages' clients and servers used across each other.
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest

from rad_tpu.build.reference import build_hnsw as ref_build_hnsw
from rad_tpu.fp import random_fingerprints
from rad_tpu.server.http_server import create_hnsw_server as ref_server
from rad_tpu.service.local import LocalHNSWService as RefLocalService
from rad_tpu.service.remote import (
    RemoteCoordinationClient as RefCoordClient,
    RemoteHNSWService as RefRemote,
)
from rad_tpu.store.smiles_store import InMemorySmilesStore as RefStore
from rad_tpu.traverse.coordinator import CoordinationService as RefCoord
from rad_tpu.traverse.workers import ScoringWorker as RefWorker
from rad_tpu_torch.api.factories import create_remote_traverser
from rad_tpu_torch.api.traverser import RADTraverser
from rad_tpu_torch.build.reference import build_hnsw
from rad_tpu_torch.server.http_server import create_hnsw_server
from rad_tpu_torch.service.local import LocalHNSWService
from rad_tpu_torch.service.remote import (
    RemoteCoordinationClient,
    RemoteHNSWService,
)
from rad_tpu_torch.store.smiles_store import InMemorySmilesStore
from rad_tpu_torch.traverse.coordinator import CoordinationService
from rad_tpu_torch.traverse.workers import ScoringWorker


def _serve(factory, graph, **kwargs):
    srv, app = factory(graph, host="127.0.0.1", port=0, **kwargs)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, app, f"http://127.0.0.1:{srv.server_address[1]}"


def _exchange(url, method, path, body=None, headers=None):
    """One raw request → (status, content type, body bytes)."""
    host, port = url[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def _prime(coord, service, scoring_fn, max_level):
    top = service.get_top_level_nodes()
    start_level = max(0, max_level - 1)
    for nid, smi in zip(top[0::2], top[1::2]):
        s = scoring_fn(smi)
        coord.scored_set.insert(nid, s, smi)
        if not coord.visited_set.checkAndInsert(nid, start_level):
            coord.priority_queue.insert(nid, start_level, s)


def _wait(coord, n_to_score, seconds=30.0):
    deadline = time.time() + seconds
    while time.time() < deadline:
        done, _ = coord.check_termination(n_to_score=n_to_score)
        if done:
            return True
        time.sleep(0.05)
    return False


@pytest.fixture(scope="module")
def graph():
    fps = random_fingerprints(100, n_bits=64, density=0.3, seed=13)
    return build_hnsw(fps, connectivity=4, expansion_add=16, seed=1)


@pytest.fixture(scope="module")
def store(graph):
    keys = np.asarray(graph.keys)
    return InMemorySmilesStore({int(k): f"SM_{int(k)}" for k in keys})


@pytest.fixture(scope="module")
def table(graph):
    keys = np.asarray(graph.keys)
    rng = np.random.default_rng(8)
    return {int(k): float(s)
            for k, s in zip(keys, rng.permutation(len(keys)).astype(float))}


def _scorer(table):
    return lambda smiles: table[int(smiles.split("_")[1])]


@pytest.fixture(scope="module")
def server(graph, store, tmp_path_factory):
    cache_dir = str(tmp_path_factory.mktemp("top_cache"))
    srv, app, url = _serve(create_hnsw_server, graph, smiles_store=store,
                           cache_dir=cache_dir)
    yield url, app
    srv.shutdown()


# ------------------------------------------- the cases of test_remote.py
def test_ping_health_info(server, graph):
    url, _ = server
    svc = RemoteHNSWService(url, max_retries=1)
    assert svc.is_healthy()
    info = svc.get_hnsw_info()
    assert info["size"] == len(graph)
    assert info["max_level"] == graph.max_level
    assert svc.get_service_info()["service_type"] == "remote"
    svc.shutdown()


def test_neighbors_and_top_nodes_format(server, graph):
    url, _ = server
    svc = RemoteHNSWService(url, max_retries=1)
    top = svc.get_top_level_nodes()
    assert len(top) == 2 * graph.layer_sizes[graph.max_level]
    nbrs = svc.get_neighbors(0, 0)
    assert len(nbrs) % 2 == 0 and len(nbrs) > 0
    keys = np.asarray(graph.keys)
    for nid, smi in zip(nbrs[0::2], nbrs[1::2]):
        assert smi == f"SM_{int(keys[nid])}"
    svc.shutdown()


def test_invalid_requests_400(server, graph):
    url, _ = server
    svc = RemoteHNSWService(url, max_retries=1)
    with pytest.raises(ValueError):
        svc.get_neighbors(len(graph) + 50, 0)
    with pytest.raises(ValueError):
        svc.get_neighbors(0, graph.max_level + 5)
    svc.shutdown()


def test_top_level_cache_persisted(server):
    import glob
    import os

    url, app = server
    svc = RemoteHNSWService(url, max_retries=1)
    svc.get_top_level_nodes()
    svc.get_top_level_nodes()
    files = glob.glob(os.path.join(app.cache_dir, "top_nodes_*.json"))
    assert len(files) == 1
    svc.shutdown()


def test_metrics_counters(server):
    url, app = server
    RemoteHNSWService(url, max_retries=1).get_neighbors(1, 0)
    stats = app.metrics.get_stats()
    assert stats["total_requests"] > 0
    assert any(k.startswith("/neighbors")
               for k in stats["requests_by_endpoint"])
    q = app.metrics.latency_quantiles("/neighbors/{}/{}")
    assert 0.0 <= q[0.5] <= q[0.99]


def test_connect_failure_raises():
    svc = RemoteHNSWService("http://127.0.0.1:1", max_retries=1,
                            backoff_factor=0.01, timeout=0.5)
    assert svc.is_healthy() is False
    with pytest.raises(ConnectionError):
        svc.get_top_level_nodes()
    svc.shutdown()


def test_retries_on_5xx_then_raises_connection_error(server):
    """429/5xx answers are retried with backoff; after the last attempt
    the builtin ConnectionError names the attempts. A 4xx is not retried."""
    url, app = server
    calls = {"n": 0}
    real = app.handle

    def flaky(method, path, body, headers):
        if path.startswith("/ping"):
            calls["n"] += 1
            return (503 if calls["n"] < 3 else 200), {"status": "ok"}
        return real(method, path, body, headers)

    app.handle = flaky
    try:
        svc = RemoteHNSWService(url, max_retries=3, backoff_factor=0.01)
        assert svc._request("GET", "/ping")["status"] == "ok"
        assert calls["n"] == 3
        calls["n"] = -10
        with pytest.raises(ConnectionError, match="after 2 attempts"):
            RemoteHNSWService(url, max_retries=1,
                              backoff_factor=0.01)._request("GET", "/ping")
        before = app.metrics.get_stats()["total_requests"]
        with pytest.raises(ValueError, match="HTTP 404"):
            svc._request("GET", "/no-such-route")
        assert app.metrics.get_stats()["total_requests"] == before + 1
        svc.shutdown()
    finally:
        app.handle = real


def test_auth_required(graph, store):
    srv, _, url = _serve(create_hnsw_server, graph, smiles_store=store,
                         api_key="sekrit")
    try:
        bad = RemoteHNSWService(url, max_retries=0)
        with pytest.raises(ValueError):
            bad.get_top_level_nodes()
        bad.shutdown()
        good = RemoteHNSWService(url, api_key="sekrit", max_retries=0)
        assert len(good.get_top_level_nodes()) > 0
        good.shutdown()
    finally:
        srv.shutdown()


def test_static_file_serving(graph, store, tmp_path):
    static = tmp_path / "static"
    static.mkdir()
    (static / "index.html").write_text("<h1>rad-tpu</h1>")
    srv, _, url = _serve(create_hnsw_server, graph, smiles_store=store,
                         static_dir=str(static))
    try:
        status, ctype, body = _exchange(url, "GET", "/static/index.html")
        assert status == 200 and b"rad-tpu" in body
        assert "text/html" in ctype
        assert _exchange(url, "GET", "/static/../secret")[0] in (403, 404)
        assert _exchange(url, "GET", "/static/nope.js")[0] == 404
    finally:
        srv.shutdown()


def test_remote_traversal_end_to_end(server, table):
    url, _ = server
    svc = RemoteHNSWService(url, max_retries=1)
    t = RADTraverser(hnsw_service=svc, scoring_fn=_scorer(table),
                     deployment_mode="remote")
    assert t.engine == "host"
    t.prime()
    stats = t.traverse(n_workers=2, n_to_score=40, poll_interval=0.02)
    assert stats["n_scored"] >= 40 or \
        stats["termination_reason"] == "queue_empty"
    ids = [m[0] for m in t.get_molecules()]
    assert len(ids) == len(set(ids))
    t.shutdown()


def test_remote_worker_joins_over_http(graph, store, table):
    """A ScoringWorker elsewhere joins through the coordination endpoints
    and unregisters when it stops."""
    service = LocalHNSWService(graph, store)
    coord = CoordinationService(service, heartbeat_interval=0.5)
    srv, _, url = _serve(create_hnsw_server, graph, smiles_store=store,
                         coordination=coord)
    try:
        _prime(coord, service, _scorer(table), graph.max_level)
        coord.start()
        client = RemoteCoordinationClient(url, max_retries=1)
        w = ScoringWorker(client, _scorer(table), poll_interval=0.01)
        w.start()
        _wait(coord, 50)
        w.stop()
        client.shutdown()
        mols = coord.scored_set.get_molecules()
        assert len(mols) >= 50
        ids = [m[0] for m in mols]
        assert len(ids) == len(set(ids))
        remote_stats = RemoteHNSWService(url, max_retries=1)._request(
            "GET", "/coordination/stats")
        assert remote_stats["total_scored"] >= 50
        assert remote_stats["workers"][w.worker_id]["completed_count"] > 0
    finally:
        coord.shutdown()
        srv.shutdown()


def test_remote_fail_work_requeues(graph, store):
    service = LocalHNSWService(graph, store)
    coord = CoordinationService(service, heartbeat_interval=0.5)
    srv, _, url = _serve(create_hnsw_server, graph, smiles_store=store,
                         coordination=coord)
    try:
        _prime(coord, service, lambda s: 1.0, graph.max_level)
        client = RemoteCoordinationClient(url, max_retries=1)
        client.register_worker("remote-w")
        item = client.request_work("remote-w")
        assert item is not None
        pq_after_pop = len(coord.priority_queue)
        assert client.fail_work("remote-w", item.work_id) is True
        assert len(coord.priority_queue) == pq_after_pop + 1
        assert client.fail_work("remote-w", item.work_id) is False
        client.shutdown()
    finally:
        coord.shutdown()
        srv.shutdown()
        service.shutdown()


def test_options_204_no_body(server):
    url, _ = server
    host, port = url[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=5)
    conn.request("OPTIONS", "/health")
    r = conn.getresponse()
    assert r.status == 204
    assert r.read() == b""
    assert r.getheader("Content-Length") in (None, "0")
    conn.request("GET", "/ping")
    r2 = conn.getresponse()
    assert r2.status == 200
    r2.read()
    conn.close()


def test_coordination_missing_field_is_400(graph, store):
    service = LocalHNSWService(graph, store)
    coord = CoordinationService(service, heartbeat_interval=0.5)
    srv, _, url = _serve(create_hnsw_server, graph, smiles_store=store,
                         coordination=coord)
    try:
        status, _, body = _exchange(
            url, "POST", "/coordination/heartbeat", b"{}",
            {"Content-Type": "application/json"})
        assert status == 400
        assert "worker_id" in json.loads(body)["detail"]
    finally:
        coord.shutdown()
        srv.shutdown()
        service.shutdown()


def test_homepage_html_for_browsers(server):
    url, _ = server
    status, ctype, body = _exchange(url, "GET", "/",
                                    headers={"Accept": "text/html"})
    assert status == 200 and ctype.startswith("text/html")
    assert b"<html" in body and b"Tanimoto" in body
    assert _exchange(url, "GET", "/")[1] == "application/json"


def test_query_string_routes_and_health_probe(server):
    url, _ = server
    status, _, body = _exchange(url, "GET", "/health?probe=1")
    assert status == 200 and json.loads(body)["status"] == "healthy"
    assert _exchange(url, "GET", "/top-level-nodes?x=y")[0] == 200


def test_info_caches_smiles_db_size(server, store):
    url, app = server
    size1 = json.loads(_exchange(url, "GET", "/info")[2])["smiles_db_size"]
    assert size1 == len(store)
    assert app._smiles_db_size == size1
    app._smiles_db_size = size1 + 123
    assert json.loads(_exchange(url, "GET", "/info")[2])[
        "smiles_db_size"] == size1 + 123
    app._smiles_db_size = size1


# --------------------------------------- routes against rad_tpu's server
# fields that hold times, uuids or the package's name: equal only in form
_VOLATILE = {"uptime_seconds", "runtime_seconds", "avg_latency_ms",
             "requests_per_second", "registered_at", "last_heartbeat",
             "assigned_at", "work_id", "avg_neighbor_fetch_ms"}


def _normal(x):
    """A body with its volatile fields replaced by their type names and a
    worker's assigned work ids by their count."""
    if isinstance(x, dict):
        return {k: (type(v).__name__ if k in _VOLATILE
                    else len(v) if k == "assigned_work" else _normal(v))
                for k, v in x.items()}
    if isinstance(x, list):
        return [_normal(v) for v in x]
    return x


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The same graph (identity keys), store and primed coordination
    served by rad_tpu's server and by the port's; static files and CORS
    on."""
    fps = random_fingerprints(90, n_bits=64, density=0.3, seed=17)
    ref_g = ref_build_hnsw(fps, connectivity=4, expansion_add=16, seed=3)
    port_g = build_hnsw(fps, connectivity=4, expansion_add=16, seed=3)
    keys = np.asarray(port_g.keys)
    mapping = {int(k): f"SM_{int(k)}" for k in keys[::3]}
    static = tmp_path_factory.mktemp("static")
    (static / "app.js").write_text("console.log(1)")
    out = {}
    for name, factory, g, svc_cls, st_cls, coord_cls in (
            ("ref", ref_server, ref_g, RefLocalService, RefStore, RefCoord),
            ("port", create_hnsw_server, port_g, LocalHNSWService,
             InMemorySmilesStore, CoordinationService)):
        store = st_cls(mapping)
        svc = svc_cls(g, store)
        coord = coord_cls(svc, worker_timeout=60, heartbeat_interval=5)
        _prime(coord, svc, lambda s: float(len(s)), g.max_level)
        srv, app, url = _serve(
            factory, g, smiles_store=store, coordination=coord,
            cache_dir=str(tmp_path_factory.mktemp(name)),
            static_dir=str(static), enable_cors=True)
        out[name] = (url, app, coord, srv)
    yield out
    for url, app, coord, srv in out.values():
        coord.shutdown()
        srv.shutdown()


_JSON = {"Content-Type": "application/json"}
ROUTES = [
    ("GET", "/", None, {}),
    ("GET", "/ping", None, {}),
    ("GET", "/health", None, {}),
    ("GET", "/health?probe=1", None, {}),
    ("GET", "/top-level-nodes", None, {}),
    ("GET", "/neighbors/0/0", None, {}),
    ("GET", "/neighbors/1/1", None, {}),
    ("GET", "/neighbors/-1/0", None, {}),
    ("GET", "/neighbors/5000/0", None, {}),
    ("GET", "/neighbors/0/9", None, {}),
    ("GET", "/neighbors/80/1", None, {}),
    ("GET", "/neighbors/x/0", None, {}),
    ("GET", "/no-such-route", None, {}),
    ("POST", "/ping", b"{}", _JSON),
    ("POST", "/coordination/heartbeat", b"not json", _JSON),
    ("POST", "/coordination/heartbeat", b"{}", _JSON),
    ("POST", "/coordination/heartbeat", b'{"worker_id": "nobody"}', _JSON),
    ("GET", "/coordination/score/0", None, {}),
    ("GET", "/coordination/score/99", None, {}),
    ("POST", "/coordination/scores", b'{"node_ids": [0, 1, 99]}', _JSON),
    ("GET", "/coordination/nope", None, {}),
    ("GET", "/static/app.js", None, {}),
    ("GET", "/static/../x", None, {}),
    ("GET", "/static/none.js", None, {}),
    ("GET", "/info", None, {}),
]


@pytest.mark.parametrize("method,path,body,headers", ROUTES,
                         ids=[f"{m} {p}" for m, p, _, _ in ROUTES])
def test_route_matches_reference_server(pair, method, path, body, headers):
    """Status, content type and body equal to rad_tpu's, the request id
    fixed through X-Correlation-ID. The JSON homepage's ``description``
    names the package, so it alone may differ."""
    got = {}
    for name in ("ref", "port"):
        url = pair[name][0]
        h = dict(headers, **{"X-Correlation-ID": "fixed-id"})
        status, ctype, data = _exchange(url, method, path, body, h)
        if ctype == "application/json":
            data = _normal(json.loads(data))
            if path == "/":
                data.pop("description")
        got[name] = (status, ctype, data)
    assert got["port"] == got["ref"]


def test_options_and_cors_headers_match_reference(pair):
    heads = {}
    for name in ("ref", "port"):
        host, port = pair[name][0][len("http://"):].split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=5)
        out = []
        for method in ("OPTIONS", "GET"):
            conn.request(method, "/ping")
            r = conn.getresponse()
            r.read()
            out.append((r.status, sorted(
                (k, v) for k, v in r.getheaders()
                if k.startswith("Access-Control") or k == "Allow")))
        conn.close()
        heads[name] = out
    assert heads["port"] == heads["ref"]
    assert heads["port"][0][0] == 204


def test_coordination_protocol_matches_reference_server(pair):
    """register → request-work → submit-results → heartbeat → error →
    request-work → fail → stats: the same bodies from both servers."""
    def run(url):
        def post(path, body):
            status, _, data = _exchange(
                url, "POST", path, json.dumps(body).encode(),
                dict(_JSON, **{"X-Correlation-ID": "c"}))
            return status, json.loads(data)

        out = [post("/coordination/register", {"worker_id": "w1"})]
        status, work = post("/coordination/request-work",
                            {"worker_id": "w1"})
        out.append((status, _normal(work)))
        item = work["work"]
        results = [[i, float(len(s)), s] for i, s in item["neighbors"]]
        out.append(post("/coordination/submit-results",
                        {"worker_id": "w1", "work_id": item["work_id"],
                         "results": results}))
        out.append(post("/coordination/submit-results",
                        {"worker_id": "w1", "work_id": item["work_id"],
                         "results": results}))
        out.append(post("/coordination/heartbeat", {"worker_id": "w1"}))
        out.append(post("/coordination/error",
                        {"worker_id": "w1", "error": "x"}))
        status, work = post("/coordination/request-work",
                            {"worker_id": "w1"})
        out.append((status, _normal(work)))
        out.append(post("/coordination/fail",
                        {"worker_id": "w1",
                         "work_id": work["work"]["work_id"]}))
        out.append(post("/coordination/register", {}))
        out[-1][1]["worker_id"] = out[-1][1]["worker_id"][:5]
        status, _, data = _exchange(url, "GET", "/coordination/stats",
                                    headers={"X-Correlation-ID": "c"})
        stats = _normal(json.loads(data))
        stats["workers"] = {k: v for k, v in stats["workers"].items()
                            if k == "w1"}
        out.append((status, stats))
        return out

    assert run(pair["port"][0]) == run(pair["ref"][0])


def test_auth_matches_reference_server(graph, store):
    got = {}
    # both servers serve the port's graph: they read only its host arrays
    for name, factory in (("ref", ref_server), ("port", create_hnsw_server)):
        srv, _, url = _serve(factory, graph, smiles_store=store,
                             api_key="k1")
        try:
            got[name] = [
                _exchange(url, m, p, None, dict(h, **{
                    "X-Correlation-ID": "c"}))[::2]
                for m, p, h in (
                    ("GET", "/ping", {}),
                    ("GET", "/health", {}),
                    ("GET", "/health", {"Authorization": "Bearer k2"}),
                    ("GET", "/health", {"Authorization": "Bearer k1"}),
                    ("GET", "/neighbors/0/0", {"Authorization": "k1"}))]
        finally:
            srv.shutdown()
    got = {k: [(s, _normal(json.loads(b))) for s, b in v]
           for k, v in got.items()}
    assert got["port"] == got["ref"]
    assert [s for s, _ in got["port"]] == [200, 401, 401, 200, 401]


# ------------------------------------------------ across the two packages
def _answers(client_cls, url, n):
    svc = client_cls(url, max_retries=1)
    out = (svc.is_healthy(), svc.get_top_level_nodes(), svc.get_hnsw_info(),
           [svc.get_neighbors(i, 0) for i in range(n)])
    svc.shutdown()
    return out


@pytest.mark.parametrize("client", ["port", "ref"])
def test_clients_read_either_server(pair, client):
    """Each package's client gets the same answers from either server."""
    cls = RemoteHNSWService if client == "port" else RefRemote
    a = _answers(cls, pair["ref"][0], 90)
    b = _answers(cls, pair["port"][0], 90)
    assert a == b and a[0] is True


@pytest.mark.parametrize("server_side", ["ref", "port"])
def test_port_remote_traversal_on_either_server(graph, store, table,
                                                server_side):
    """create_remote_traverser at one worker against rad_tpu's server
    gives the order it gives against the port's."""
    orders = []
    for factory in (ref_server if server_side == "ref" else
                    create_hnsw_server, create_hnsw_server):
        srv, _, url = _serve(factory, graph, smiles_store=store)
        try:
            t = create_remote_traverser(url, _scorer(table))
            t.prime()
            t.traverse(n_workers=1, n_to_score=60, poll_interval=0.01)
            orders.append(t.get_molecules())
            t.shutdown()
        finally:
            srv.shutdown()
    k = min(map(len, orders))
    assert k >= 60 and orders[0][:k] == orders[1][:k]


@pytest.mark.parametrize("worker_side", ["port", "ref"])
def test_worker_joins_the_other_package_server(graph, store, table,
                                               worker_side):
    """rad_tpu's worker and client join the port's server, and the port's
    worker and client join rad_tpu's."""
    if worker_side == "port":
        svc = RefLocalService(graph, store)
        coord = RefCoord(svc, heartbeat_interval=0.5)
        factory, client_cls, worker_cls = (ref_server,
                                           RemoteCoordinationClient,
                                           ScoringWorker)
    else:
        svc = LocalHNSWService(graph, store)
        coord = CoordinationService(svc, heartbeat_interval=0.5)
        factory, client_cls, worker_cls = (create_hnsw_server,
                                           RefCoordClient, RefWorker)
    srv, _, url = _serve(factory, graph, smiles_store=store,
                         coordination=coord)
    try:
        _prime(coord, svc, _scorer(table), graph.max_level)
        coord.start()
        client = client_cls(url, max_retries=1)
        w = worker_cls(client, _scorer(table), poll_interval=0.01)
        w.start()
        assert _wait(coord, 50)
        w.stop()
        client.shutdown()
        mols = coord.scored_set.get_molecules()
        keys = np.asarray(graph.keys)
        assert len({m[0] for m in mols}) == len(mols) >= 50
        assert all(s == table[int(keys[i])] for i, s, _ in mols)
    finally:
        coord.shutdown()
        srv.shutdown()
