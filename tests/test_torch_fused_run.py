"""rad_tpu_torch's device-scored traversal and checkpoints against rad_tpu.

The graph of ``tests/test_pallas_ops.py`` (300 rows, 128 bits, M = 4)
goes through ``fused_run`` / ``fused_step`` / ``make_device_run`` in both
packages from the same primed start; every field of the final state must
be array-equal (the port's through ``state_to_reference_arrays``, which
drops its sentinel slots). Checkpoints cross between the packages both
ways and resume into the uninterrupted run.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rad_tpu.build.exact import build_hnsw_exact
from rad_tpu.build.reference import build_hnsw
from rad_tpu.fp import random_fingerprints
from rad_tpu.fp.tanimoto import tanimoto_rows_to_target as ref_rows_to_target
from rad_tpu.store.smiles_store import InMemorySmilesStore as RefStore
from rad_tpu.traverse import device as ref_dev
from rad_tpu.traverse.driver import DeviceTraverser as RefTraverser
from rad_tpu_torch.fp.pack import to_torch_packed
from rad_tpu_torch.fp.tanimoto import tanimoto_rows_to_target
from rad_tpu_torch.graph.storage import HNSWGraph
from rad_tpu_torch.store import InMemorySmilesStore
from rad_tpu_torch.traverse import candidate_ops
from rad_tpu_torch.traverse import device as dev
from rad_tpu_torch.traverse.driver import DeviceTraverser

TARGET = 17


def _port_graph(ref):
    return HNSWGraph(np.asarray(ref.packed), np.asarray(ref.popcounts),
                     np.asarray(ref.keys), np.asarray(ref.levels),
                     tuple(np.asarray(t) for t in ref.neighbors), ref.ndim,
                     ref.connectivity)


@pytest.fixture(scope="module")
def case():
    fps = random_fingerprints(300, n_bits=128, density=0.3, seed=9)
    ref = build_hnsw_exact(fps, connectivity=4, seed=1)
    port = _port_graph(ref)
    rdg = ref_dev.prepare_device_graph(ref)
    dg = dev.prepare_device_graph(port, "cpu")
    packed = to_torch_packed(np.array(ref.packed), "cpu")
    pops = torch.from_numpy(np.asarray(ref.popcounts).astype(np.int32))
    return ref, port, rdg, dg, packed, pops


def _ref_arrays(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(ref_dev.TraversalState)}


def assert_states_equal(port_state, ref_state):
    got = (dev.state_to_reference_arrays(port_state)
           if isinstance(port_state, dev.TraversalState) else port_state)
    want = (_ref_arrays(ref_state)
            if isinstance(ref_state, ref_dev.TraversalState) else ref_state)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _ref_primed(case, **init):
    ref, _, rdg, *_ = case
    n_top = ref.layer_sizes[ref.max_level]
    seeds = jnp.arange(n_top, dtype=jnp.int32)
    s0 = ref_rows_to_target(ref.packed[seeds], ref.popcounts[seeds],
                            ref.packed[TARGET], ref.popcounts[TARGET])
    return ref_dev.prime(ref_dev.init_state(rdg, **init), rdg, seeds, s0)


def _port_primed(case, **init):
    ref, _, _, dg, packed, pops = case
    n_top = ref.layer_sizes[ref.max_level]
    seeds = torch.arange(n_top, dtype=torch.int32)
    s0 = tanimoto_rows_to_target(packed[:n_top], pops[:n_top],
                                 packed[TARGET], pops[TARGET])
    return dev.prime(dev.init_state(dg, **init), dg, seeds, s0)


def _ref_fused_run(case, n_to_score, **kw):
    ref, _, rdg, *_ = case
    return ref_dev.fused_run(_ref_primed(case), rdg, ref.packed,
                             ref.popcounts, ref.packed[TARGET],
                             ref.popcounts[TARGET], jnp.int32(n_to_score),
                             batch=8, **kw)


def _port_fused_run(case, n_to_score, **kw):
    _, _, _, dg, packed, pops = case
    return dev.fused_run(_port_primed(case), dg, packed, pops,
                         packed[TARGET], pops[TARGET], n_to_score, batch=8,
                         **kw)


@pytest.mark.parametrize("narrow", [None, 16])
@pytest.mark.parametrize("fused", [False, True])
def test_fused_run_matches_reference(case, fused, narrow):
    want = _ref_fused_run(case, 250, narrow_width=narrow,
                          fused_candidates=fused)
    got = _port_fused_run(case, 250, narrow_width=narrow,
                          fused_candidates=fused)
    assert int(got.n_scored) >= 250
    assert_states_equal(got, want)


def test_fused_run_stops_on_the_reference_step(case):
    """max_steps and an exhausted frontier end the loop where the
    reference's while_loop ends."""
    for kw, n in ((dict(max_steps=7), 10 ** 6), ({}, 10 ** 6)):
        want = _ref_fused_run(case, n, **kw)
        got = _port_fused_run(case, n, fused_candidates=True, **kw)
        assert int(got.n_steps) == int(want.n_steps)
        assert_states_equal(got, want)
    assert int(got.f_live) == 0


def test_fused_steps_equal_fused_run(case):
    _, _, _, dg, packed, pops = case
    st = _port_primed(case, frontier_capacity=1 << 12)
    for _ in range(20):
        st = dev.fused_step(st, dg, packed, pops, packed[TARGET],
                            pops[TARGET], batch=8)
    run = dev.fused_run(_port_primed(case, frontier_capacity=1 << 12), dg,
                        packed, pops, packed[TARGET], pops[TARGET], 10 ** 9,
                        batch=8, max_steps=20)
    assert int(st.n_steps) == 20
    assert_states_equal(st, dev.state_to_reference_arrays(run))


def _table(case):
    ref = case[0]
    rng = np.random.default_rng(4)
    return rng.permutation(len(ref)).astype(np.float32)


def _ref_device_run(case, n_to_score, **kw):
    ref, _, rdg, *_ = case
    table = jnp.asarray(_table(case))
    run = ref_dev.make_device_run(rdg, jnp.zeros((len(ref), 1), jnp.uint8),
                                  table, lambda _rows, t: t, batch=4, **kw)
    n_top = ref.layer_sizes[ref.max_level]
    st = ref_dev.prime(ref_dev.init_state(rdg, frontier_capacity=1 << 10),
                       rdg, jnp.arange(n_top, dtype=jnp.int32),
                       table[:n_top])
    return run(st, jnp.int32(n_to_score))


def _port_device_run(case, n_to_score, **kw):
    ref, _, _, dg, *_ = case
    table = torch.from_numpy(_table(case))
    dummy = torch.zeros((len(ref), 1), dtype=torch.uint8)
    run = dev.make_device_run(dg, dummy, table, lambda _rows, t: t, batch=4,
                              **kw)
    n_top = ref.layer_sizes[ref.max_level]
    st = dev.prime(dev.init_state(dg, frontier_capacity=1 << 10), dg,
                   torch.arange(n_top, dtype=torch.int32), table[:n_top])
    return run(st, n_to_score)


def test_make_device_run_respects_budget(case):
    got = _port_device_run(case, 100)
    n = int(got.n_scored)
    assert 100 <= n <= 100 + 4 * case[3].m0
    log = dev.read_order_log(got)
    assert len(set(log.tolist())) == n
    assert_states_equal(got, _ref_device_run(case, 100))


@pytest.mark.parametrize("narrow", [8, 16])
def test_make_device_run_narrow_width_agrees(case, narrow):
    full = _port_device_run(case, 10 ** 9)
    got = _port_device_run(case, 10 ** 9, narrow_width=narrow)
    assert_states_equal(
        _port_device_run(case, 10 ** 9, narrow_width=narrow,
                         fused_candidates=True),
        dev.state_to_reference_arrays(got))
    assert int(got.n_scored) > 290
    assert_states_equal(got, dev.state_to_reference_arrays(full))
    assert_states_equal(got, _ref_device_run(case, 10 ** 9,
                                             narrow_width=narrow))


def test_make_device_run_step_budget_resumes(case):
    """A run cut by step_budget and run again continues the same
    trajectory."""
    ref, _, _, dg, *_ = case
    table = torch.from_numpy(_table(case))
    run = dev.make_device_run(dg, torch.zeros((len(ref), 1)), table,
                              lambda _rows, t: t * 2, batch=4)
    n_top = ref.layer_sizes[ref.max_level]

    def primed():
        return dev.prime(dev.init_state(dg, frontier_capacity=1 << 10), dg,
                         torch.arange(n_top, dtype=torch.int32),
                         table[:n_top] * 2)
    a = run(run(primed(), 200, step_budget=5), 200)
    b = run(primed(), 200)
    assert int(a.n_steps) > 5
    assert_states_equal(a, dev.state_to_reference_arrays(b))


# -------------------------------------------------------------- checkpoints

@pytest.fixture(scope="module")
def small():
    n = 200
    fps = random_fingerprints(n, n_bits=64, density=0.3, seed=29)
    ref = build_hnsw(fps, connectivity=4, expansion_add=16, seed=8)
    keys = np.asarray(ref.keys)
    rng = np.random.default_rng(5)
    table = {int(k): float(s)
             for k, s in zip(keys, rng.permutation(n).astype(float))}
    smiles = {int(k): f"C_{int(k)}" for k in keys}
    return ref, _port_graph(ref), smiles, \
        lambda s: table[int(s.split("_")[1])]


def _traverser(small, port: bool, **kw):
    ref, port_g, smiles, fn = small
    if port:
        return DeviceTraverser(port_g, fn, InMemorySmilesStore(smiles),
                               batch_size=4, frontier_capacity=1 << 12,
                               n_score_threads=1, device="cpu", **kw)
    return RefTraverser(ref, fn, RefStore(smiles), batch_size=4,
                        frontier_capacity=1 << 12, n_score_threads=1, **kw)


@pytest.mark.parametrize("writer_is_port", [False, True])
def test_checkpoint_crosses_packages_and_resumes(small, tmp_path,
                                                 writer_is_port):
    """Half a run in one package, checkpointed; the other package resumes
    it and ends where an uninterrupted reference run ends."""
    full = _traverser(small, port=False)
    full.prime()
    full.traverse(n_to_score=10 ** 9, timeout=60)

    t1 = _traverser(small, port=writer_is_port)
    t1.prime()
    t1.traverse(n_to_score=60)
    ckpt = str(tmp_path / "trav.npz")
    t1.save_checkpoint(ckpt)
    mid = t1.n_scored

    t2 = _traverser(small, port=not writer_is_port)
    t2.load_checkpoint(ckpt)
    assert t2.n_scored == mid
    t2.traverse(n_to_score=10 ** 9, timeout=60)
    assert t2.get_molecules() == full.get_molecules()
    port_t = t2 if not writer_is_port else None
    if port_t is not None:
        assert_states_equal(port_t.state, full.state)
    for t in (full, t1, t2):
        t.shutdown()


def test_checkpoint_rejects_wrong_graph(small, tmp_path):
    t = _traverser(small, port=True)
    t.prime()
    ckpt = str(tmp_path / "c.npz")
    t.save_checkpoint(ckpt)
    t.shutdown()
    other = build_hnsw(random_fingerprints(50, n_bits=64, seed=1),
                       connectivity=4, expansion_add=8)
    t2 = DeviceTraverser(_port_graph(other), small[3], n_score_threads=1,
                         device="cpu")
    with pytest.raises(ValueError):
        t2.load_checkpoint(ckpt)
    t2.shutdown()


def test_checkpoint_roundtrip_any_suffix(small, tmp_path):
    t = _traverser(small, port=True)
    t.prime()
    t.traverse(n_to_score=40)
    p = tmp_path / "run.ckpt"             # no .npz suffix on purpose
    t.save_checkpoint(str(p))
    assert p.exists()
    t2 = _traverser(small, port=True)
    t2.load_checkpoint(str(p))
    assert t2.n_scored == t.n_scored
    assert_states_equal(t2.state, dev.state_to_reference_arrays(t.state))
    assert torch.equal(t2.state.order_log, t.state.order_log)
    # a bare save_state() output: np.savez appended the suffix
    dev.save_state(t.state, str(tmp_path / "bare"))
    assert_states_equal(dev.load_state(str(tmp_path / "bare"), "cpu"),
                        dev.state_to_reference_arrays(t.state))
    for x in (t, t2):
        x.shutdown()


def test_two_level_checkpoint_roundtrip(case, tmp_path):
    _, _, _, dg, packed, pops = case
    kw = dict(frontier_capacity=1 << 12, buffer_capacity=64,
              head_capacity=64)
    st = dev.fused_run(_port_primed(case, **kw), dg, packed, pops,
                       packed[TARGET], pops[TARGET], 10 ** 9, batch=8,
                       max_steps=10)
    assert st.cold_score.shape[0] == (1 << 12) + 1 and int(st.cold_n) > 0
    p = str(tmp_path / "two_level.npz")
    dev.save_state(st, p)
    assert_states_equal(dev.load_state(p, "cpu"), ref_dev.load_state(p))
    ref_st = ref_dev.load_state(p)
    st2 = dev.load_state(p, "cpu")
    a = dev.fused_run(st, dg, packed, pops, packed[TARGET], pops[TARGET],
                      10 ** 9, batch=8)
    b = dev.fused_run(st2, dg, packed, pops, packed[TARGET], pops[TARGET],
                      10 ** 9, batch=8)
    assert_states_equal(a, dev.state_to_reference_arrays(b))
    ref, _, rdg, *_ = case
    want = ref_dev.fused_run(ref_st, rdg, ref.packed, ref.popcounts,
                             ref.packed[TARGET], ref.popcounts[TARGET],
                             jnp.int32(10 ** 9), batch=8)
    assert_states_equal(a, want)


@pytest.mark.parametrize("drop", [("f_live",),
                                  ("cold_score", "cold_row", "cold_n",
                                   "watermark"),
                                  ("f_live", "cold_score", "cold_row",
                                   "cold_n", "watermark")])
def test_load_state_reads_older_reference_forms(case, tmp_path, drop):
    """rad_tpu's pre-f_live and single-level checkpoints load as its own
    load_state loads them."""
    st = _ref_fused_run(case, 120)
    arrays = {k: v for k, v in _ref_arrays(st).items() if k not in drop}
    p = str(tmp_path / "old.npz")
    np.savez(p, **arrays)
    assert_states_equal(dev.load_state(p, "cpu"), ref_dev.load_state(p))


def test_read_order_log_since(case):
    st = _port_fused_run(case, 120)
    log = dev.read_order_log(st)
    n = int(st.n_scored)
    np.testing.assert_array_equal(dev.read_order_log_since(st, 30),
                                  log[30:])
    np.testing.assert_array_equal(
        dev.read_order_log_since(st, 30),
        ref_dev.read_order_log_since(_ref_fused_run(case, 120), 30))
    assert dev.read_order_log_since(st, n).shape == (0,)
    small_ring = dev.init_state(case[3], log_capacity=16)
    small_ring.n_scored = torch.tensor(40, dtype=torch.int32)
    with pytest.raises(RuntimeError):
        dev.read_order_log_since(small_ring, 0)


def test_fused_candidates_on_cpu_use_twins(case):
    """A CPU state takes the twins: no kernel launch is counted."""
    before = (candidate_ops.candidate_filter.launches,
              candidate_ops.integrate_candidates.launches)
    _port_fused_run(case, 100, fused_candidates=True)
    assert (candidate_ops.candidate_filter.launches,
            candidate_ops.integrate_candidates.launches) == before
