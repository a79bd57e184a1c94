"""rad_tpu_torch's graph-sharded engine against rad_tpu's (CPU).

The 15 cases of ``tests/test_parallel.py`` on both packages: the
reference on the conftest's 8 virtual CPU devices, the port on a
single-controller mesh of ``[cpu] * 8``. The graph of that file (300 rows,
128 bits, M = 6) is built by ``rad_tpu.build.reference.build_hnsw`` and
carried across as arrays; every input comes from a numpy seed.

Bars: ids, orders, scored sets, enqueued tables, frontiers, traffic
counts and search results array-equal; f32 scores and distances
bit-equal (``assert_array_equal``). The port's sharded step is also held
to its own single-device engine, whose semantics it reuses.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rad_tpu.build.reference import build_hnsw
from rad_tpu.fp import popcount_rows as ref_popcount_rows
from rad_tpu.fp import random_fingerprints
from rad_tpu.fp.tanimoto import tanimoto_matrix as ref_tanimoto_matrix
from rad_tpu.parallel import make_mesh as ref_make_mesh
from rad_tpu.parallel import sharded as ref_sh
from rad_tpu.parallel.pod import PodTraverser as RefPod
from rad_tpu.traverse import device as ref_dev
from rad_tpu.traverse import multi as ref_multi
from rad_tpu_torch.fp.pack import popcount_rows, to_torch_packed
from rad_tpu_torch.fp.tanimoto import bruteforce_topk, tanimoto_matrix
from rad_tpu_torch.graph.storage import HNSWGraph
from rad_tpu_torch.parallel import make_mesh, sharded as sh
from rad_tpu_torch.parallel.pod import PodTraverser, _padded_device_graph
from rad_tpu_torch.search.knn import search_device
from rad_tpu_torch.traverse import device as dev
from rad_tpu_torch.traverse import multi

CPU = torch.device("cpu")
STEPS, BATCH = 12, 4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return ref_make_mesh(8), make_mesh(8, devices=[CPU] * 8)


@pytest.fixture(scope="module")
def built():
    fps = random_fingerprints(300, n_bits=128, density=0.25, seed=31)
    ref = build_hnsw(fps, connectivity=6, expansion_add=40, seed=4)
    port = HNSWGraph(np.asarray(ref.packed), np.asarray(ref.popcounts),
                     np.asarray(ref.keys), np.asarray(ref.levels),
                     tuple(np.asarray(t) for t in ref.neighbors), ref.ndim,
                     ref.connectivity)
    return ref, port


@pytest.fixture(scope="module")
def shards(meshes, built):
    (rm, pm), (ref, port) = meshes, built
    return ref_sh.shard_graph(ref, rm), sh.shard_graph(port, pm)


def _target(seed):
    t = random_fingerprints(1, n_bits=128, density=0.25, seed=seed)[0]
    tr = jnp.asarray(t)
    tp = to_torch_packed(t[None, :], "cpu")[0]
    return (t, tr, ref_popcount_rows(tr[None, :])[0], tp,
            popcount_rows(tp[None, :])[0])


def _seeds(ref, port, t):
    n_top = ref.layer_sizes[ref.max_level]
    r = ref_tanimoto_matrix(jnp.asarray(t[None, :]),
                            jnp.asarray(np.asarray(ref.packed)[:n_top]))[0]
    p = tanimoto_matrix(to_torch_packed(t[None, :], "cpu"),
                        to_torch_packed(np.asarray(port.packed)[:n_top],
                                        "cpu"))[0]
    np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    return (jnp.arange(n_top, dtype=jnp.int32), r,
            torch.arange(n_top, dtype=torch.int32), p)


def _ref_arrays(state) -> dict:
    return {k: np.asarray(v) for k, v in vars(state).items()}


def _assert_states_equal(ref_state, port_state, n=None):
    want = _ref_arrays(ref_state)
    got = sh.sharded_state_to_reference_arrays(port_state)
    for k, v in want.items():
        a = got[k]
        if n is not None and k in ("scored", "scores"):
            a, v = a[:n], v[:n]
        np.testing.assert_array_equal(a, v, err_msg=k)


def _ref_single(ref, tgt, steps=STEPS, batch=BATCH):
    t, tr, trp, _, _ = tgt
    ids, seeds, _, _ = _seeds(ref, ref, t)
    dg = ref_dev.prepare_device_graph(ref)
    st = ref_dev.prime(ref_dev.init_state(dg, frontier_capacity=1 << 10),
                       dg, ids, seeds)
    packed = jnp.asarray(np.asarray(ref.packed))
    pops = jnp.asarray(np.asarray(ref.popcounts))
    for _ in range(steps):
        st = ref_dev.fused_step(st, dg, packed, pops, tr, trp, batch=batch)
    return st


def _port_pod(psg, pm, port, tgt, full=False, steps=STEPS, batch=BATCH,
              traffic=False, sg=None):
    t, _, _, tp, tpp = tgt
    _, _, ids, seeds = _seeds(port, port, t)
    sg = psg if sg is None else sg
    if full:
        dg = _padded_device_graph(sg)
        st = sh.init_state_sharded(sg, pm, 1 << 10, len(port))
        step = sh.make_sharded_step_full(sg, pm, batch, traffic=traffic)
    else:
        dg = sg.device_graph()
        st = dev.init_state(dg, frontier_capacity=1 << 10)
        step = sh.make_sharded_step(sg, pm, batch, traffic=traffic)
    st = dev.prime(st, dg, ids, seeds)
    counts = []
    for _ in range(steps):
        st = step(st, tp, tpp)
        if traffic:
            st, tr = st
            counts.append(tr)
    return (st, counts) if traffic else st


def test_make_mesh_shapes(monkeypatch):
    m1 = make_mesh(4, devices=[CPU] * 8)
    assert m1.shape == {"graph": 4} == ref_make_mesh(4).shape
    m2 = make_mesh((2, 4), axis_names=("data", "graph"), devices=[CPU] * 8)
    assert m2.shape == {"data": 2, "graph": 4}
    assert m2.devices.shape == (2, 4) and m2.lead == CPU
    for bad in (lambda: make_mesh(9, devices=[CPU] * 8),
                lambda: make_mesh((2, 4), devices=[CPU] * 8),
                lambda: make_mesh(None, ("data", "graph"), [CPU] * 8)):
        with pytest.raises(ValueError):
            bad()
    # never a CPU fallback: no CUDA device and no devices= raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4)


def test_shard_graph_layout(meshes, built, shards):
    _, port = built
    rsg, psg = shards
    assert (psg.n_pad_nodes, psg.n_pad_rows, psg.n_nodes, psg.n_rows) == \
        (rsg.n_pad_nodes, rsg.n_pad_rows, rsg.n_nodes, rsg.n_rows)
    assert len(psg.adj.shards) == 8 and psg.n_pad_nodes % 8 == 0
    # the assembled shards are the reference's global arrays: padded
    # tails inert (-1 adjacency, zero fingerprints)
    np.testing.assert_array_equal(psg.adj.full().numpy(), np.asarray(rsg.adj))
    np.testing.assert_array_equal(psg.packed.full().numpy().view(np.uint32),
                                  np.asarray(rsg.packed))
    np.testing.assert_array_equal(psg.pops.full().numpy(),
                                  np.asarray(rsg.pops))
    assert (psg.adj.full()[psg.n_rows:] == -1).all()
    # every shard lives on its own device, a row block each
    assert [t.shape[0] for t in psg.adj.shards] == [psg.n_pad_rows // 8] * 8


def test_sharded_bruteforce_matches_dense(meshes, shards, built):
    (rm, pm), (rsg, psg), (ref, port) = meshes, shards, built
    queries = random_fingerprints(6, n_bits=128, density=0.25, seed=90)
    rd, ri = ref_sh.sharded_bruteforce_topk(rsg, queries, k=8, mesh=rm)
    d, i = sh.sharded_bruteforce_topk(psg, queries, k=8, mesh=pm)
    np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    # and the single-device scan (ties to the smaller id in both)
    d1, i1 = bruteforce_topk(to_torch_packed(queries, "cpu"),
                             to_torch_packed(np.asarray(port.packed), "cpu"),
                             8)
    np.testing.assert_array_equal(d.numpy(), d1.numpy())
    np.testing.assert_array_equal(i.numpy(), i1.numpy())


def test_pod_traverser_lifecycle(meshes, built):
    (rm, pm), (ref, port) = meshes, built
    t = _target(77)[0]
    got = []
    for cls, g, m in ((RefPod, ref, rm), (PodTraverser, port, pm)):
        pod = cls(g, t, mesh=m, batch_size=8, frontier_capacity=1 << 10)
        with pytest.raises(RuntimeError):
            pod.traverse(n_to_score=5)
        pod.prime()
        stats = pod.traverse(n_to_score=120, timeout=120)
        assert stats["n_scored"] >= 120
        got.append((pod.get_molecules(), pod.get_best_molecules(5),
                    pod.get_stats()))
    (r_mols, r_best, r_stats), (mols, best, stats) = got
    assert mols == r_mols and best == r_best
    assert [m[1] for m in best] == sorted(m[1] for m in mols)[:5]
    assert best[0][1] < np.median([m[1] for m in mols])
    for k in ("n_scored", "frontier_size", "frontier_dropped",
              "device_steps", "n_devices", "shard_state", "steps"):
        assert stats[k] == r_stats[k], k


def test_fully_sharded_state_matches_replicated(meshes, shards, built):
    """Graph and state sharded: equal to the replicated-state pod step,
    to the reference's fully sharded step, state for state."""
    (rm, pm), (rsg, psg), (ref, port) = meshes, shards, built
    tgt = _target(55)
    t, tr, trp = tgt[:3]
    ids, seeds, _, _ = _seeds(ref, port, t)
    dg_pad = ref_dev.DeviceGraph(adj=rsg.adj, offsets=rsg.offsets,
                                 n_nodes=rsg.n_pad_nodes,
                                 n_rows=rsg.n_pad_rows, m0=rsg.m0,
                                 max_level=rsg.max_level)
    rs = ref_sh.init_state_sharded(rsg, rm, frontier_capacity=1 << 10,
                                   log_capacity=len(ref))
    rs = ref_dev.prime(rs, dg_pad, ids, seeds)
    step = ref_sh.make_sharded_step_full(rsg, rm, batch=BATCH)
    for _ in range(STEPS):
        rs = step(rs, tr, trp)
    full = _port_pod(psg, pm, port, tgt, full=True)
    _assert_states_equal(rs, full)
    rep = _port_pod(psg, pm, port, tgt)
    a, b = (sh.sharded_state_to_reference_arrays(s) for s in (rep, full))
    assert int(rep.n_scored) == int(full.n_scored) > len(ids)
    for k in a:
        n = {"scored": len(port), "scores": len(port),
             "enqueued": psg.n_rows}.get(k)
        np.testing.assert_array_equal(a[k], b[k][:n] if n else b[k],
                                      err_msg=k)
    # the state really is split: one [shard + 1] table per device
    assert [t.shape[0] for t in full.scored.shards] == \
        [psg.n_pad_nodes // 8 + 1] * 8


def test_pod_traverser_shard_state(meshes, built):
    (rm, pm), (ref, port) = meshes, built
    t = _target(77)[0]
    results = []
    for shard_state in (False, True):
        for cls, g, m in ((RefPod, ref, rm), (PodTraverser, port, pm)):
            pod = cls(g, t, mesh=m, batch_size=8, frontier_capacity=1 << 10,
                      shard_state=shard_state)
            pod.prime()
            pod.traverse(n_to_score=100, timeout=120)
            results.append(pod.get_molecules())
    assert all(r == results[0] for r in results[1:])


def test_pod_traverser_custom_scorer(meshes, built):
    (rm, pm), (ref, port) = meshes, built
    t = _target(78)[0]

    def ref_scorer(fp_rows, pop_rows, target_packed, target_pop):
        return (pop_rows % 7).astype(jnp.float32)

    def scorer(fp_rows, pop_rows, target_packed, target_pop):
        return (pop_rows % 7).to(torch.float32)

    got = []
    for cls, g, m, fn in ((RefPod, ref, rm, ref_scorer),
                          (PodTraverser, port, pm, scorer)):
        pod = cls(g, t, mesh=m, batch_size=8, frontier_capacity=1 << 10,
                  scorer=fn)
        pod.prime()
        pod.traverse(n_to_score=60, timeout=60)
        got.append(pod.get_molecules())
    assert got[0] == got[1] and len(got[1]) >= 60
    n_top = port.layer_sizes[port.max_level]
    assert all(m[1] == float(int(m[1])) and 0 <= m[1] < 7
               for m in got[1][n_top:])


def test_sharded_beam_search_matches_single_device(meshes, shards, built):
    """The sharded beam (one expansion per iteration, as the reference's)
    returns the single-device search at ``expand_width=1``, and the
    reference's sharded search."""
    (rm, pm), (rsg, psg), (ref, port) = meshes, shards, built
    queries = random_fingerprints(8, n_bits=128, density=0.25, seed=61)
    d, i = sh.make_sharded_search(psg, pm, k=5, ef=32, batch=8)(queries)
    d1, i1 = search_device(port, queries, k=5, expansion_search=32,
                           expand_width=1, device="cpu")
    np.testing.assert_array_equal(d.numpy(), d1.numpy())
    np.testing.assert_array_equal(i.numpy(), i1.numpy())
    rd, ri = ref_sh.make_sharded_search(rsg, rm, k=5, ef=32, batch=8)(
        jnp.asarray(queries))
    np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    with pytest.raises(ValueError, match="batch=8"):
        sh.make_sharded_search(psg, pm, k=5, ef=32, batch=8)(queries[:4])


def test_sharded_traversal_matches_single_device(meshes, shards, built):
    """The pod step's state equals the single-device fused step's, in
    both packages, field for field."""
    (rm, pm), (rsg, psg), (ref, port) = meshes, shards, built
    tgt = _target(55)
    ref_state = _ref_single(ref, tgt)
    pod = _port_pod(psg, pm, port, tgt)
    _assert_states_equal(ref_state, pod)
    # the port's own single-device engine
    t, _, _, tp, tpp = tgt
    _, _, ids, seeds = _seeds(port, port, t)
    dg = dev.prepare_device_graph(port, "cpu")
    st = dev.prime(dev.init_state(dg, frontier_capacity=1 << 10), dg, ids,
                   seeds)
    packed = to_torch_packed(np.asarray(port.packed), "cpu")
    pops = torch.from_numpy(np.asarray(port.popcounts).astype(np.int32))
    for _ in range(STEPS):
        st = dev.fused_step(st, dg, packed, pops, tp, tpp, BATCH)
    _assert_states_equal(ref_state, st)
    # the memoized one-shot wrapper steps the same way
    st2 = dev.prime(dev.init_state(psg.device_graph(),
                                   frontier_capacity=1 << 10),
                    psg.device_graph(), ids, seeds)
    for _ in range(STEPS):
        st2 = sh.sharded_fused_step(st2, psg, pm, tp, tpp, BATCH)
    _assert_states_equal(ref_state, st2)


def test_sharded_search_2d_matches_1d(built):
    ref, port = built
    m2 = make_mesh((2, 4), axis_names=("data", "graph"), devices=[CPU] * 8)
    m1 = make_mesh(8, devices=[CPU] * 8)
    queries = np.asarray(port.packed)[:16]
    d2, i2 = sh.make_sharded_search_2d(sh.shard_graph(port, m2), m2, k=4,
                                       ef=16, batch=16)(queries)
    d1, i1 = sh.make_sharded_search(sh.shard_graph(port, m1), m1, k=4,
                                    ef=16, batch=16)(queries)
    np.testing.assert_array_equal(d2.numpy(), d1.numpy())
    np.testing.assert_array_equal(i2.numpy(), i1.numpy())
    assert (d2[:, 0] == 0).all() and i2[:, 0].tolist() == list(range(16))
    with pytest.raises(ValueError, match="does not split"):
        sh.make_sharded_search_2d(sh.shard_graph(port, m2), m2, k=4, ef=16,
                                  batch=15)
    rm2 = ref_make_mesh((2, 4), axis_names=("data", "graph"))
    rd, ri = ref_sh.make_sharded_search_2d(
        ref_sh.shard_graph(ref, rm2), rm2, k=4, ef=16, batch=16)(
        jnp.asarray(queries))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ri))


def test_traffic_counters_match_host_recount(meshes, shards, built):
    """Per-shard counts equal the reference's and a host recount from
    the single-device engine's expand outputs; counting changes nothing."""
    (rm, pm), (rsg, psg), (ref, port) = meshes, shards, built
    tgt = _target(55)
    t, tr, trp, tp, tpp = tgt
    st, counts = _port_pod(psg, pm, port, tgt, steps=10, traffic=True)
    meter = sh.TrafficMeter(8)
    for c in counts:
        meter.add(c)
    ids, seeds, _, _ = _seeds(ref, port, t)
    dg = ref_dev.prepare_device_graph(ref)
    rs = ref_dev.prime(ref_dev.init_state(dg, frontier_capacity=1 << 10),
                       dg, ids, seeds)
    step = ref_sh.make_sharded_step(rsg, rm, batch=BATCH, traffic=True)
    ref_meter = ref_sh.TrafficMeter(8)
    for _ in range(10):
        rs, tr_ = step(rs, tr, trp)
        ref_meter.add(tr_)
    np.testing.assert_array_equal(meter.adj_rows, ref_meter.adj_rows)
    np.testing.assert_array_equal(meter.fp_rows, ref_meter.fp_rows)
    assert meter.stats() == ref_meter.stats()
    # host recount from the port's single-device expand outputs
    adj_shard, fp_shard = psg.n_pad_rows // 8, psg.n_pad_nodes // 8
    pdg = dev.prepare_device_graph(port, "cpu")
    _, _, pids, pseeds = _seeds(port, port, t)
    sh_ = dev.prime(dev.init_state(pdg, frontier_capacity=1 << 10), pdg,
                    pids, pseeds)
    packed = to_torch_packed(np.asarray(port.packed), "cpu")
    pops = torch.from_numpy(np.asarray(port.popcounts).astype(np.int32))
    exp_adj, exp_fp = np.zeros(8, np.int64), np.zeros(8, np.int64)
    for _ in range(10):
        sh_, out = dev.expand(sh_, pdg, BATCH)
        ts = out["to_score"].numpy()
        rows = pdg.offsets_host[np.maximum(out["exp_level"].numpy(), 0)] \
            + np.maximum(out["exp_node"].numpy(), 0)
        np.add.at(exp_adj, rows[out["exp_valid"].numpy()] // adj_shard, 1)
        np.add.at(exp_fp, ts[ts >= 0] // fp_shard, 1)
        scores = dev._target_scorer(packed, pops, tp, tpp)(out["to_score"])
        sh_ = dev.integrate(sh_, pdg, out["exp_node"], out["exp_level"],
                            out["exp_score"], out["exp_valid"], out["cand"],
                            out["to_score"], scores)
    np.testing.assert_array_equal(meter.adj_rows, exp_adj)
    np.testing.assert_array_equal(meter.fp_rows, exp_fp)
    assert meter.stats()["adj_imbalance"] >= 1.0
    plain = _port_pod(psg, pm, port, tgt, steps=10)
    _assert_states_equal(_ref_arrays_state(plain), st)


def _ref_arrays_state(state):
    """A port state viewed as a reference state (for the comparison
    helper): its reference-layout arrays as attributes."""
    class _View:
        pass
    v = _View()
    vars(v).update(sh.sharded_state_to_reference_arrays(state))
    return v


def test_traffic_counters_fully_sharded(meshes, shards, built):
    (rm, pm), (rsg, psg), (ref, port) = meshes, shards, built
    tgt = _target(55)
    _, cr = _port_pod(psg, pm, port, tgt, steps=8, traffic=True)
    _, cf = _port_pod(psg, pm, port, tgt, full=True, steps=8, traffic=True)
    m_r, m_f = sh.TrafficMeter(8), sh.TrafficMeter(8)
    for a, b in zip(cr, cf):
        m_r.add(a)
        m_f.add(b)
    np.testing.assert_array_equal(m_r.adj_rows, m_f.adj_rows)
    np.testing.assert_array_equal(m_r.fp_rows, m_f.fp_rows)
    assert m_r.steps == m_f.steps == 8


def test_multi_campaign_pod_matches_solo_pod(meshes, shards, built):
    """T campaigns over the sharded graph: each equals its solo pod run
    at the same budget, and the reference's pod panel, state for state."""
    (rm, pm), (rsg, psg), (ref, port) = meshes, shards, built
    # budgets cut from the reference case's 60 / 120 / 90: still unequal,
    # so campaigns freeze at different steps
    t_count, budgets = 3, [30, 60, 45]
    targets_np = random_fingerprints(t_count, n_bits=128, density=0.25,
                                     seed=91)
    frontier, buffer = 1 << 11, 1 << 8
    n_top = ref.layer_sizes[ref.max_level]
    # the reference's panel over its pod
    rtg = jnp.asarray(targets_np)
    rtp = ref_popcount_rows(rtg)
    rdg = ref_dev.prepare_device_graph(ref)
    rseeds = ref_tanimoto_matrix(rtg, jnp.asarray(np.asarray(ref.packed))
                                 [:n_top])
    rstates = ref_multi.prime_multi(
        ref_multi.init_multi(rdg, t_count, frontier_capacity=frontier,
                             buffer_capacity=buffer), rdg,
        jnp.arange(n_top, dtype=jnp.int32), rseeds)
    rstep = ref_sh.make_sharded_step_multi(rsg, rm, batch=BATCH)
    rb = jnp.asarray(budgets, jnp.int32)
    for _ in range(200):
        if not bool(jnp.any(ref_multi.multi_active_mask(rstates, rb))):
            break
        rstates = rstep(rstates, rtg, rtp, rb)
    # the port's
    tg = to_torch_packed(targets_np, "cpu")
    tpp = popcount_rows(tg)
    dg = psg.device_graph()
    ids = torch.arange(n_top, dtype=torch.int32)
    seeds = tanimoto_matrix(tg, to_torch_packed(
        np.asarray(port.packed)[:n_top], "cpu"))
    states = multi.prime_multi(
        multi.init_multi(dg, t_count, frontier_capacity=frontier,
                         buffer_capacity=buffer), dg, ids, seeds)
    step = sh.make_sharded_step_multi(psg, pm, batch=BATCH)
    for _ in range(200):
        if not bool(multi.multi_active_mask(states, budgets).any()):
            break
        states = step(states, tg, tpp, torch.tensor(budgets))
    solo_step = sh.make_sharded_step(psg, pm, batch=BATCH)
    for c in range(t_count):
        got = multi.campaign_state(states, c)
        want = {k: np.asarray(v)[c] for k, v in vars(rstates).items()}
        arr = dev.state_to_reference_arrays(got)
        for k, v in want.items():
            np.testing.assert_array_equal(arr[k], v, err_msg=f"{c}:{k}")
        st = dev.prime(dev.init_state(dg, frontier_capacity=frontier,
                                      buffer_capacity=buffer,
                                      head_capacity=None), dg, ids, seeds[c])
        while int(st.n_scored) < budgets[c] and int(st.f_live) > 0:
            st = solo_step(st, tg[c], tpp[c])
        solo = dev.state_to_reference_arrays(st)
        assert int(got.n_scored) == int(st.n_scored) >= budgets[c]
        for k in ("scored", "order_log", "scores", "n_dropped"):
            np.testing.assert_array_equal(arr[k], solo[k], err_msg=k)


def test_packed_adjacency_pod_bit_identical(meshes, built, shards):
    """Packed sharded adjacency: the replicated-state step, the fully
    sharded step and the sharded search equal the int32 storage's."""
    (rm, pm), (ref, port), (_, psg) = meshes, built, shards
    from rad_tpu_torch.graph.adjpack import adj_bits_for, packed_adj_words
    sg_p = sh.shard_graph(port, pm, packed_adjacency=True)
    bits = adj_bits_for(len(port))
    assert sg_p.adj_bits == bits
    assert sg_p.adj.shape == (psg.n_pad_rows, packed_adj_words(psg.m0, bits))
    tgt = _target(77)
    for full in (False, True):
        a = _port_pod(psg, pm, port, tgt, full=full)
        b = _port_pod(psg, pm, port, tgt, full=full, sg=sg_p)
        _assert_states_equal(_ref_arrays_state(a), b)
        assert int(a.n_scored) > port.layer_sizes[port.max_level]
    queries = random_fingerprints(5, n_bits=128, density=0.25, seed=78)
    d_u, i_u = sh.make_sharded_search(psg, pm, k=6, ef=24, batch=5)(queries)
    d_p, i_p = sh.make_sharded_search(sg_p, pm, k=6, ef=24, batch=5)(queries)
    np.testing.assert_array_equal(i_u.numpy(), i_p.numpy())
    np.testing.assert_array_equal(d_u.numpy(), d_p.numpy())


def test_shard_graph_streamed_matches_materialized(meshes, built, shards):
    """Per-shard host callbacks build the layout shard_graph builds, for
    int32 and packed adjacency, each shard requested once; the pod step
    over it is the same."""
    (rm, pm), (ref, port), (_, psg) = meshes, built, shards
    dg = dev.prepare_device_graph(port, "cpu")
    adj_np = dg.adj.numpy()
    fps_np = np.asarray(port.packed)
    calls = []

    def make_sg(packed_adjacency, pops=False):
        return sh.shard_graph_streamed(
            pm, n_nodes=len(port), layer_sizes=port.layer_sizes, m0=dg.m0,
            make_adj_rows=lambda s, e: (calls.append((s, e)),
                                        adj_np[s:e])[1],
            make_packed_rows=lambda s, e: fps_np[s:e],
            make_pops_rows=(lambda s, e: np.asarray(port.popcounts)[s:e])
            if pops else None,
            fp_words=fps_np.shape[1], packed_adjacency=packed_adjacency)

    for packed_adjacency in (False, True):
        want = sh.shard_graph(port, pm, packed_adjacency=packed_adjacency)
        got = make_sg(packed_adjacency, pops=packed_adjacency)
        assert (got.n_pad_rows, got.n_pad_nodes, got.adj_bits) == \
            (want.n_pad_rows, want.n_pad_nodes, want.adj_bits)
        for name in ("adj", "packed", "pops"):
            np.testing.assert_array_equal(getattr(got, name).full().numpy(),
                                          getattr(want, name).full().numpy())
        np.testing.assert_array_equal(got.offsets.numpy(),
                                      want.offsets.numpy())
        assert len(calls) == 8 and len(set(calls)) == 8
        calls.clear()
    tgt = _target(78)
    a = _port_pod(psg, pm, port, tgt, steps=10)
    b = _port_pod(psg, pm, port, tgt, steps=10, sg=make_sg(False))
    _assert_states_equal(_ref_arrays_state(a), b)
    with pytest.raises(ValueError, match="divisible"):
        sh.put_sharded_rows(pm, "graph", (9, 2), np.int32,
                            lambda s, e: np.zeros((e - s, 2), np.int32))
