"""rad_tpu_torch's host engine against rad_tpu's.

The host structures (heap with lazy deletion, visited and scored sets),
the coordination service's fault tolerance (the cases of
``tests/test_fault_tolerance.py`` run against the port), the host engine
at one worker against rad_tpu's host engine (scored set, scores and
order) and against the port's device engine at batch 1, and the
traverser's deployment modes and engine rules.
"""

import time

import numpy as np
import pytest

from rad_tpu.build.reference import build_hnsw as ref_build_hnsw
from rad_tpu.fp import random_fingerprints
from rad_tpu.service.local import LocalHNSWService as RefLocalService
from rad_tpu.store.smiles_store import InMemorySmilesStore as RefStore
from rad_tpu.traverse import structures as ref_structures
from rad_tpu.traverse.coordinator import CoordinationService as RefCoord
from rad_tpu.traverse.workers import WorkerPool as RefPool
from rad_tpu_torch.api.traverser import RADTraverser
from rad_tpu_torch.build.reference import build_hnsw
from rad_tpu_torch.service.local import LocalHNSWService
from rad_tpu_torch.store.smiles_store import InMemorySmilesStore
from rad_tpu_torch.traverse import structures
from rad_tpu_torch.traverse.coordinator import CoordinationService
from rad_tpu_torch.traverse.driver import DeviceTraverser
from rad_tpu_torch.traverse.workers import ScoringWorker, WorkerPool


# ------------------------------------------------------------ structures
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_priority_queue_matches_reference(seed):
    """The same random inserts (scores from a small set, so ties and
    overwrites are common) and pops: the same pops, lengths and peeks,
    ties broken by insertion order."""
    rng = np.random.default_rng(seed)
    a, b = ref_structures.HostPriorityQueue(), structures.HostPriorityQueue()
    for _ in range(600):
        if rng.random() < 0.6:
            args = (int(rng.integers(0, 40)), int(rng.integers(0, 3)),
                    float(rng.integers(0, 6)))
            a.insert(*args)
            b.insert(*args)
        else:
            assert a.pop() == b.pop()
        assert len(a) == len(b)
        assert a.peek_score() == b.peek_score()
    while len(a):
        assert a.pop() == b.pop()
    assert b.pop() is None


def test_priority_queue_ties_pop_in_insertion_order():
    q = structures.HostPriorityQueue()
    for nid in (5, 3, 9, 1, 4):
        q.insert(nid, 0, 2.0)
    q.insert(3, 0, 2.0)          # same score: its first entry stays live
    q.insert(9, 0, 3.0)          # new score: the old entry goes stale
    q.insert(9, 0, 2.0)          # and back: its first entry is live again
    q.insert(7, 1, 1.0)
    assert len(q) == 6
    assert [q.pop()[0] for _ in range(6)] == [7, 5, 3, 9, 1, 4]
    assert q.pop() is None and len(q) == 0


def test_visited_and_scored_sets_match_reference(tmp_path):
    rng = np.random.default_rng(5)
    va, vb = ref_structures.HostVisitedSet(), structures.HostVisitedSet()
    sa, sb = ref_structures.HostScoredSet(), structures.HostScoredSet()
    for _ in range(400):
        nid, lvl = int(rng.integers(0, 60)), int(rng.integers(0, 3))
        assert va.checkAndInsert(nid, lvl) == vb.check_and_insert(nid, lvl)
        score = float(rng.integers(0, 20))
        sa.insert(nid, score, f"S{nid}")
        sb.insert(nid, score, f"S{nid}")
    assert len(va) == len(vb) and ((3, 1) in va) == ((3, 1) in vb)
    assert len(sa) == len(sb)
    assert sa.get_molecules() == sb.get_molecules()
    assert sa.get_molecules(7) == sb.get_molecules(7)
    assert sa.get_best_molecules(10) == sb.get_best_molecules(10)
    assert sa.get_best_molecules() == sb.get_best_molecules()
    assert list(sa) == list(sb)
    ids = list(range(-1, 62))
    assert sa.get_scores_batch(ids) == sb.get_scores_batch(ids)
    assert [sa.getScore(i) for i in ids] == [sb.get_score(i) for i in ids]
    sa.save(str(tmp_path / "a.txt"))
    sb.save(str(tmp_path / "b.txt"))
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()


def test_structures_abcs_refuse_incomplete_subclasses():
    class Half(structures.ScoredSet):
        def getScore(self, node_id):
            return None

    with pytest.raises(TypeError):
        Half()
    for abc in (structures.PriorityQueue, structures.VisitedSet,
                structures.ScoredSet):
        with pytest.raises(TypeError):
            abc()


# ------------------------------------------------------ fault tolerance
@pytest.fixture()
def wiring():
    n = 120
    fps = random_fingerprints(n, n_bits=64, density=0.3, seed=43)
    graph = build_hnsw(fps, connectivity=4, expansion_add=16, seed=3)
    keys = np.asarray(graph.keys)
    rng = np.random.default_rng(7)
    table = {int(k): float(s)
             for k, s in zip(keys, rng.permutation(n).astype(float))}
    store = InMemorySmilesStore({int(k): f"F_{int(k)}" for k in keys})
    service = LocalHNSWService(graph, store)

    def scoring_fn(s):
        return table[int(s.split("_")[1])]

    return graph, service, scoring_fn


def _prime(coord, service, scoring_fn, graph):
    top = service.get_top_level_nodes()
    lvl = max(0, graph.max_level - 1)
    for nid, smi in zip(top[0::2], top[1::2]):
        s = scoring_fn(smi)
        coord.scored_set.insert(nid, s, smi)
        if not coord.visited_set.checkAndInsert(nid, lvl):
            coord.priority_queue.insert(nid, lvl, s)


def _wait_done(coord, n_to_score=10**9, seconds=30.0):
    deadline = time.time() + seconds
    done = False
    while time.time() < deadline:
        done, _ = coord.check_termination(n_to_score=n_to_score)
        if done:
            break
        time.sleep(0.05)
    return done


def test_dead_worker_work_reassigned(wiring):
    """A worker that takes work and vanishes: the monitor marks it dead
    after worker_timeout and re-enqueues its assignment."""
    graph, service, scoring_fn = wiring
    coord = CoordinationService(service, worker_timeout=0.3,
                                heartbeat_interval=0.1,
                                monitor_interval=0.05)
    _prime(coord, service, scoring_fn, graph)
    coord.start()
    try:
        coord.register_worker("zombie")
        assert coord.request_work("zombie") is not None
        pq_after_pop = len(coord.priority_queue)
        deadline = time.time() + 5
        while time.time() < deadline:
            if coord.get_coordination_stats()["reassigned_work_items"] >= 1:
                break
            time.sleep(0.05)
        stats = coord.get_coordination_stats()
        assert stats["reassigned_work_items"] >= 1
        assert stats["workers"]["zombie"]["status"] == "dead"
        assert len(coord.priority_queue) == pq_after_pop + 1
        w = ScoringWorker(coord, scoring_fn, poll_interval=0.01)
        w.start()
        _wait_done(coord)
        w.stop()
        ids = [m[0] for m in coord.scored_set.get_molecules()]
        assert len(ids) == len(set(ids))
        assert len(ids) > 2
    finally:
        coord.shutdown()
        service.shutdown()


def test_heartbeat_revives_worker(wiring):
    graph, service, scoring_fn = wiring
    coord = CoordinationService(service, worker_timeout=0.2,
                                monitor_interval=0.05)
    coord.start()
    try:
        coord.register_worker("w1")
        time.sleep(0.5)
        stats = coord.get_coordination_stats()
        assert stats["workers"]["w1"]["status"] == "dead"
        assert coord.worker_heartbeat("w1") is True
        assert coord.get_coordination_stats()["workers"]["w1"]["status"] \
            == "active"
    finally:
        coord.shutdown()
        service.shutdown()


def test_stale_submission_dropped(wiring):
    """Results for reassigned work ids are rejected."""
    graph, service, scoring_fn = wiring
    coord = CoordinationService(service, worker_timeout=60)
    _prime(coord, service, scoring_fn, graph)
    coord.register_worker("w")
    item = coord.request_work("w")
    with coord._lock:
        coord._outstanding.pop(item.work_id)
    assert coord.submit_work_results("w", item.work_id,
                                     [(0, 1.0, "F_0")]) is False
    coord.shutdown()
    service.shutdown()


def test_failed_work_requeued_immediately(wiring):
    """fail_work requeues at once; a worker whose scoring_fn fails for a
    while still lets the traversal finish with no duplicate scores."""
    graph, service, scoring_fn = wiring
    coord = CoordinationService(service, worker_timeout=60)
    _prime(coord, service, scoring_fn, graph)
    coord.register_worker("w")
    item = coord.request_work("w")
    assert item is not None
    pq_after_pop = len(coord.priority_queue)
    assert coord.fail_work("w", item.work_id) is True
    assert len(coord.priority_queue) == pq_after_pop + 1
    assert coord.fail_work("w", item.work_id) is False
    assert coord.submit_work_results("w", item.work_id, []) is False

    boom = {"armed": True}

    def flaky(s):
        if boom["armed"] and int(s.split("_")[1]) % 3 == 0:
            raise RuntimeError("dock crashed")
        return scoring_fn(s)

    coord.start()
    try:
        w = ScoringWorker(coord, flaky, poll_interval=0.01)
        w.start()
        time.sleep(0.5)
        boom["armed"] = False
        done = _wait_done(coord)
        w.stop()
        assert done
        ids = [m[0] for m in coord.scored_set.get_molecules()]
        assert len(ids) == len(set(ids))
        assert len(ids) > 2
    finally:
        coord.shutdown()
        service.shutdown()


def test_scoring_failures_use_failed_score(wiring):
    """The device engine: a scoring exception becomes failed_score and the
    traversal goes on."""
    graph, _, scoring_fn = wiring
    keys = np.asarray(graph.keys)
    store = InMemorySmilesStore({int(k): f"F_{int(k)}" for k in keys})
    calls = {"n": 0}

    def flaky(s):
        calls["n"] += 1
        if calls["n"] % 5 == 0:
            raise RuntimeError("dock crashed")
        return scoring_fn(s)

    tr = DeviceTraverser(graph, flaky, store, batch_size=4,
                         frontier_capacity=1 << 12, n_score_threads=1,
                         failed_score=999.0, device="cpu")
    tr.prime()
    tr.traverse(n_to_score=10**9, timeout=60)
    mols = tr.get_molecules()
    assert tr.stats["scoring_errors"] > 0
    assert len([m for m in mols if m[1] == 999.0]) == \
        tr.stats["scoring_errors"]
    ids = [m[0] for m in mols]
    assert len(ids) == len(set(ids))
    tr.shutdown()


def test_reregistration_keeps_assignments(wiring):
    """A duplicate register keeps the worker's in-flight items, so they
    are requeued when it goes silent."""
    graph, service, scoring_fn = wiring
    coord = CoordinationService(service, worker_timeout=0.5,
                                monitor_interval=0.05)
    _prime(coord, service, scoring_fn, graph)
    coord.register_worker("w1")
    item = coord.request_work("w1")
    assert item is not None
    assert coord._workers["w1"].assigned_work == {item.work_id}
    coord.register_worker("w1")
    assert coord._workers["w1"].assigned_work == {item.work_id}
    coord.start()
    try:
        deadline = time.time() + 5.0
        while time.time() < deadline and coord._reassigned_count < 1:
            time.sleep(0.05)
        assert coord._reassigned_count >= 1
        assert item.work_id not in coord._outstanding
    finally:
        coord.shutdown()


def test_reset_termination_clears_sticky_verdict(wiring):
    graph, service, scoring_fn = wiring
    coord = CoordinationService(service)
    _prime(coord, service, scoring_fn, graph)
    assert coord.check_termination(n_to_score=1) == (True, "n_to_score")
    assert coord.check_termination(n_to_score=10**9) == (True, "n_to_score")
    coord.reset_termination()
    assert coord.check_termination(n_to_score=10**9) == (False, None)


def test_work_item_wire_form_round_trips(wiring):
    from rad_tpu.traverse.coordinator import WorkItem as RefItem
    from rad_tpu_torch.traverse.coordinator import WorkerInfo, WorkItem

    graph, service, scoring_fn = wiring
    coord = CoordinationService(service)
    _prime(coord, service, scoring_fn, graph)
    item = coord.request_work("w")
    wire = item.to_dict()
    assert WorkItem.from_dict(wire).to_dict() == wire
    assert RefItem.from_dict(wire).to_dict() == wire
    assert set(WorkerInfo("w").to_dict()) >= {"worker_id", "status"}


# ----------------------------------------------- host engine vs rad_tpu
@pytest.fixture(scope="module")
def graphs():
    """One 300-row library built by both packages' host builders
    (edge-identical), a store and tie-free scores."""
    n = 300
    fps = random_fingerprints(n, n_bits=64, density=0.3, seed=23)
    keys = np.arange(n, dtype=np.int64) + 500
    ref = ref_build_hnsw(fps, keys=keys, connectivity=4, expansion_add=16,
                         seed=4)
    port = build_hnsw(fps, keys=keys, connectivity=4, expansion_add=16,
                      seed=4)
    for a, b in zip(ref.neighbors, port.neighbors):
        assert np.array_equal(np.asarray(a), b)
    rng = np.random.default_rng(9)
    table = {int(k): float(s)
             for k, s in zip(keys, rng.permutation(n).astype(float))}
    mapping = {int(k): f"K_{int(k)}" for k in keys}
    return ref, port, table, mapping


def _score_fn(table):
    return lambda s: table[int(s.split("_")[1])]


def _run_host(coord_cls, pool_cls, service, scoring_fn, max_level,
              n_workers=1, n_to_score=10**9):
    coord = coord_cls(service, worker_timeout=10, heartbeat_interval=1)
    top = service.get_top_level_nodes()
    start_level = max(0, max_level - 1)
    for nid, smi in zip(top[0::2], top[1::2]):
        s = scoring_fn(smi)
        coord.scored_set.insert(nid, s, smi)
        if not coord.visited_set.checkAndInsert(nid, start_level):
            coord.priority_queue.insert(nid, start_level, s)
    coord.start()
    pool = pool_cls(coord, scoring_fn, n_workers=n_workers)
    pool.start_all()
    deadline = time.time() + 60
    reason = None
    while time.time() < deadline:
        done, reason = coord.check_termination(n_to_score=n_to_score)
        if done:
            break
        time.sleep(0.02)
    pool.stop_all()
    coord.shutdown()
    service.shutdown()
    return coord, reason


def test_host_engine_matches_reference_host_engine(graphs):
    """One worker to exhaustion: the same scored set, scores and order
    as rad_tpu's host engine."""
    ref, port, table, mapping = graphs
    fn = _score_fn(table)
    a, ra = _run_host(RefCoord, RefPool,
                      RefLocalService(ref, RefStore(mapping)), fn,
                      ref.max_level)
    b, rb = _run_host(CoordinationService, WorkerPool,
                      LocalHNSWService(port, InMemorySmilesStore(mapping)),
                      fn, port.max_level)
    assert ra == rb == "queue_empty"
    assert a.scored_set.get_molecules() == b.scored_set.get_molecules()
    assert len(b.scored_set) > 100


@pytest.mark.parametrize("n_workers", [1, 3])
def test_traverser_host_engine_matches_reference(graphs, n_workers):
    """The facades: create_distributed_traverser on both packages. At one
    worker the order is the reference's over the common prefix; at three
    the scored molecules are distinct and carry their true scores."""
    from rad_tpu.api.factories import create_distributed_traverser as ref_f
    from rad_tpu_torch.api.factories import create_distributed_traverser

    ref, port, table, mapping = graphs
    fn = _score_fn(table)
    runs = []
    for factory, g, store in ((ref_f, ref, RefStore(mapping)),
                              (create_distributed_traverser, port,
                               InMemorySmilesStore(mapping))):
        t = factory(g, fn, smiles_store=store, n_workers=n_workers)
        assert t.engine == "host" and t.deployment_mode == "distributed"
        t.prime()
        stats = t.traverse(n_to_score=120, poll_interval=0.01)
        assert stats["termination_reason"] == "n_to_score"
        runs.append(t.get_molecules())
        t.shutdown()
    a, b = runs
    ids = [m[0] for m in b]
    assert len(ids) == len(set(ids)) and len(ids) >= 120
    keys = np.asarray(port.keys)
    assert all(s == table[int(keys[i])] and smi == mapping[int(keys[i])]
               for i, s, smi in b)
    if n_workers == 1:
        k = min(len(a), len(b))
        assert a[:k] == b[:k]


def test_host_engine_matches_device_engine_at_batch_1(graphs):
    """The port's invariant: the device engine at batch 1 (one frontier
    level) reproduces the host engine's scored set, scores and order."""
    _, port, table, mapping = graphs
    fn = _score_fn(table)
    coord, reason = _run_host(
        CoordinationService, WorkerPool,
        LocalHNSWService(port, InMemorySmilesStore(mapping)), fn,
        port.max_level)
    host = coord.scored_set.get_molecules()
    t = RADTraverser(graph=port, scoring_fn=fn,
                     smiles_store=InMemorySmilesStore(mapping),
                     engine="device", batch_size=1, head_capacity=None,
                     n_score_threads=1, device="cpu")
    assert t.engine == "device"
    t.prime()
    t.traverse(n_to_score=10**9)
    dev = t.get_molecules()
    t.shutdown()
    assert reason == "queue_empty"
    assert [(m[0], m[1]) for m in host] == [(m[0], m[1]) for m in dev]


# ------------------------------------------------ modes and engine rules
def test_deployment_modes_and_engine_rules(graphs):
    _, port, table, mapping = graphs
    fn = _score_fn(table)
    t = RADTraverser(graph=port, scoring_fn=fn, device="cpu")
    assert (t.engine, t.deployment_mode) == ("device", "local")
    t.shutdown()
    for mode, want in (("distributed", "distributed"),
                       ("hybrid", "distributed"), ("remote", "remote")):
        t = RADTraverser(graph=port, scoring_fn=fn, deployment_mode=mode)
        assert (t.engine, t.deployment_mode) == ("host", want)
        t.shutdown()
    t = RADTraverser(LocalHNSWService(port), fn, engine="host")
    assert (t.engine, t.deployment_mode) == ("host", "local")
    t.shutdown()
    # the pod mode runs the graph-sharded engine on the given mesh, and
    # without a mesh it needs CUDA devices: no CPU fallback
    import torch
    from rad_tpu_torch.parallel import PodTraverser, make_mesh
    t = RADTraverser(graph=port, scoring_fn=fn, deployment_mode="pod",
                     mesh=make_mesh(2, devices=["cpu"] * 2))
    assert (t.engine, t.deployment_mode) == ("pod", "pod")
    assert isinstance(t._device_engine, PodTraverser)
    t.shutdown()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RADTraverser(graph=port, scoring_fn=fn, deployment_mode="pod")
    with pytest.raises(ValueError, match="deployment_mode"):
        RADTraverser(graph=port, scoring_fn=fn, deployment_mode="cloud")
    with pytest.raises(ValueError, match="engine"):
        RADTraverser(graph=port, scoring_fn=fn, engine="quantum")
    with pytest.raises(TypeError, match="bogus"):
        RADTraverser(graph=port, scoring_fn=fn, engine="host", bogus=1)
    with pytest.raises(ValueError):
        RADTraverser(scoring_fn=fn)


def test_host_parameters_reach_the_coordination_and_pool(graphs):
    """namespace, worker_timeout, heartbeat_interval and n_workers reach
    the CoordinationService and the WorkerPool; a second traverse()
    starts a fresh termination round; shutdown runs workers, then
    coordination, then the service."""
    _, port, table, mapping = graphs
    svc = LocalHNSWService(port, InMemorySmilesStore(mapping))
    t = RADTraverser(svc, _score_fn(table), deployment_mode="distributed",
                     namespace="ns1", worker_timeout=7.0,
                     heartbeat_interval=0.25, n_workers=3)
    coord = t._coord
    assert (coord.namespace, coord.worker_timeout,
            coord.heartbeat_interval) == ("ns1", 7.0, 0.25)
    t.prime()
    assert len(t.scored_set) == port.layer_sizes[-1]
    t.traverse(n_to_score=40, poll_interval=0.01)
    pool = t._pool
    assert len(pool.workers) == 3
    stats = t.traverse(n_to_score=80, poll_interval=0.01)
    assert stats["termination_reason"] == "n_to_score"
    assert stats["n_scored"] >= 80
    info = t.get_traversal_stats()
    assert info["namespace"] == "ns1" and info["engine"] == "host"
    assert info["coordination"]["total_workers"] == 6
    t.shutdown()
    assert not any(w.is_running for w in pool.workers)
    assert not coord.is_running and not svc.is_healthy()
    with pytest.raises(RuntimeError):
        t.prime()


def test_device_views_subclass_the_host_abcs(graphs):
    _, port, table, mapping = graphs
    t = RADTraverser(graph=port, scoring_fn=_score_fn(table),
                     smiles_store=InMemorySmilesStore(mapping),
                     n_score_threads=1, device="cpu")
    t.prime()
    assert isinstance(t.scored_set, structures.ScoredSet)
    assert isinstance(t.priority_queue, structures.PriorityQueue)
    assert isinstance(t.visited_set, structures.VisitedSet)
    assert len(t.scored_set) == port.layer_sizes[-1]
    for view, call in ((t.scored_set, lambda v: v.insert(0, 1.0)),
                       (t.priority_queue, lambda v: v.pop()),
                       (t.visited_set, lambda v: v.checkAndInsert(0, 0))):
        with pytest.raises(RuntimeError):
            call(view)
    t.shutdown()
