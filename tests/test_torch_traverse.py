"""rad_tpu_torch's traversal engine against rad_tpu's DeviceTraverser.

Same graph, same tie-free scores (a hash of the key): the scoring order
(``get_molecules``) and the best molecules must be identical at every
batch size, in the single-level frontier and in a two-level frontier
small enough that merges, spills to the cold store and refills all run.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rad_tpu.build.reference import build_hnsw
from rad_tpu.fp import random_fingerprints
from rad_tpu.traverse import device as ref_dev
from rad_tpu.traverse.driver import DeviceTraverser as RefTraverser
from rad_tpu_torch.graph.storage import HNSWGraph
from rad_tpu_torch.traverse import device as dev
from rad_tpu_torch.traverse.driver import DeviceTraverser
from rad_tpu_torch.traverse.pipeline import HostScoringBridge


@pytest.fixture(scope="module")
def graphs():
    fps = random_fingerprints(1200, n_bits=64, density=0.3, seed=31)
    keys = np.arange(1200, dtype=np.int64) + 1000
    ref = build_hnsw(fps, keys=keys, connectivity=5, expansion_add=24,
                     seed=2)
    port = HNSWGraph(np.asarray(ref.packed), np.asarray(ref.popcounts),
                     np.asarray(ref.keys), np.asarray(ref.levels),
                     tuple(np.asarray(t) for t in ref.neighbors), ref.ndim,
                     ref.connectivity)
    return ref, port


def _score(smiles: str) -> float:
    # tie-free: a bijective-ish hash of the key
    return float((int(smiles) * 2654435761) % (1 << 31)) / (1 << 31)


def _run_both(graphs, batch, n_to_score, pipeline_depth=1, **kw):
    ref_g, port_g = graphs
    a = RefTraverser(ref_g, _score, batch_size=batch, n_score_threads=1,
                     **kw)
    b = DeviceTraverser(port_g, _score, batch_size=batch,
                        n_score_threads=1, device="cpu", **kw)
    for t in (a, b):
        t.prime()
        t.traverse(n_to_score=n_to_score, pipeline_depth=pipeline_depth)
    return a, b


@pytest.mark.parametrize("batch,depth", [(1, 1), (8, 1), (32, 1), (8, 2)])
def test_order_identical_to_reference(graphs, batch, depth):
    a, b = _run_both(graphs, batch, 600, pipeline_depth=depth)
    mols = b.get_molecules()
    assert len(mols) >= 600
    assert mols == a.get_molecules()
    assert b.get_best_molecules(50) == a.get_best_molecules(50)
    sa, sb = a.get_stats(), b.get_stats()
    for key in ("n_scored", "frontier_size", "frontier_dropped",
                "device_steps", "termination_reason"):
        assert sa[key] == sb[key], key
    ids = [m[0] for m in mols]
    assert len(set(ids)) == len(ids)


def test_two_level_spills_and_refills_identical(graphs, monkeypatch):
    """Head 32 / buffer 40: merges spill to the cold store every few
    steps, and the exhaustive sweep drains the head over and over, so the
    refill path runs many times; the frontier (4096) never drops."""
    refills = []
    real = dev._refill_two_level

    def counting(state):
        refills.append(int(state.cold_n))
        return real(state)

    monkeypatch.setattr(dev, "_refill_two_level", counting)
    kw = dict(head_capacity=32, buffer_capacity=40,
              frontier_capacity=1 << 12)
    a, b = _run_both(graphs, 8, 10_000, **kw)
    assert b.state.cold_score.shape[0] == (1 << 12) + 1
    assert len(refills) > 5 and max(refills) > 0
    assert a.get_stats()["termination_reason"] == "queue_empty"
    assert b.get_molecules() == a.get_molecules()
    assert b.n_scored == a.n_scored > 1100   # every reachable node
    assert int(b.state.n_dropped) == int(a.state.n_dropped) == 0


@pytest.mark.parametrize("kw", [
    dict(head_capacity=32, buffer_capacity=40, frontier_capacity=128),
    dict(head_capacity=None, buffer_capacity=40, frontier_capacity=64),
    # a buffer smaller than one step's pushes forces a merge every step
    dict(head_capacity=None, buffer_capacity=8, frontier_capacity=64),
])
def test_overflowing_frontier_drops_identically(graphs, kw):
    a, b = _run_both(graphs, 8, 10_000, **kw)
    assert int(b.state.n_dropped) == int(a.state.n_dropped) > 0
    assert b.get_molecules() == a.get_molecules()
    assert b.get_stats()["frontier_size"] == 0


def test_auto_two_level_matches_reference(graphs, monkeypatch):
    for mod in (dev, ref_dev):
        monkeypatch.setattr(mod, "AUTO_HEAD_CAPACITY", 64)
        monkeypatch.setattr(mod, "AUTO_HEAD_THRESHOLD", 1 << 11)
    a, b = _run_both(graphs, 8, 900, buffer_capacity=64)
    assert b.state.f_score.shape[0] == 64
    assert b.get_molecules() == a.get_molecules()
    assert b.get_best_molecules(20) == a.get_best_molecules(20)


def test_f_live_matches_recount_every_step(graphs):
    _, g = graphs
    dg = dev.prepare_device_graph(g, "cpu")
    st = dev.init_state(dg, frontier_capacity=1 << 12, buffer_capacity=40,
                        head_capacity=32)
    n_top = g.layer_sizes[g.max_level]
    ids = torch.arange(n_top, dtype=torch.int32)
    st = dev.prime(st, dg, ids, torch.tensor(
        [_score(str(int(k))) for k in g.keys[:n_top]]))
    bridge = HostScoringBridge(g.keys, _score, n_score_threads=1)
    steps = 0
    while dev.frontier_size(st) > 0:
        st, out = dev.expand(st, dg, 8)
        ts = out["to_score"].numpy()
        st = dev.integrate(st, dg, out["exp_node"], out["exp_level"],
                           out["exp_score"], out["exp_valid"], out["cand"],
                           out["to_score"],
                           torch.from_numpy(bridge.score_batch(ts)))
        assert dev.frontier_size(st) == dev.frontier_live_scan(st)
        steps += 1
    bridge.shutdown()
    assert int(st.n_scored) > 0.9 * len(g)
    assert steps == int(st.n_steps)


def test_prime_insert_if_absent_matches_reference(graphs):
    ref_g, g = graphs
    rdg = ref_dev.prepare_device_graph(ref_g)
    dg = dev.prepare_device_graph(g, "cpu")
    seeds = np.array([0, 1, 1, -1, 2, 0, 3], np.int32)  # dups and padding
    scores = np.array([0.5, 0.2, 0.9, 0.0, 0.7, 0.1, 0.3], np.float32)
    ra = ref_dev.init_state(rdg, frontier_capacity=1 << 12)
    pa = dev.init_state(dg, frontier_capacity=1 << 12)
    for _ in range(2):   # the second prime is a no-op re-prime
        ra = ref_dev.prime(ra, rdg, jnp.asarray(seeds), jnp.asarray(scores))
        pa = dev.prime(pa, dg, torch.from_numpy(seeds),
                       torch.from_numpy(scores))
        assert int(pa.n_scored) == int(ra.n_scored) == 4
        assert int(pa.f_live) == int(ra.f_live) == 4
        np.testing.assert_array_equal(dev.read_order_log(pa),
                                      ref_dev.read_order_log(ra))
        np.testing.assert_array_equal(pa.f_score.numpy(),
                                      np.asarray(ra.f_score))
        np.testing.assert_array_equal(pa.f_row.numpy(), np.asarray(ra.f_row))
        np.testing.assert_array_equal(pa.enqueued[:-1].numpy(),
                                      np.asarray(ra.enqueued))


def test_first_occurrence_forms_agree():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 50, size=400).astype(np.int32)
    vals[::7] = 50                                   # the sentinel
    ref = np.asarray(ref_dev._first_occurrence(jnp.asarray(vals), 50))
    t = torch.from_numpy(vals)
    np.testing.assert_array_equal(dev._first_occurrence(t, 50).numpy(), ref)
    np.testing.assert_array_equal(
        dev._first_occurrence_scatter(t, 50).numpy(), ref)


def test_unported_options_raise(graphs):
    _, g = graphs
    with pytest.raises(NotImplementedError):
        DeviceTraverser(g, _score, packed_adjacency=True, device="cpu")
    with pytest.raises(NotImplementedError):
        DeviceTraverser(g, _score, order_log_spill=True, device="cpu")


def test_periodic_checkpoint_restores_n_scored(graphs, tmp_path):
    """traverse(checkpoint_path=...) leaves the file behind; a fresh
    traverser's load_checkpoint restores n_scored and the scoring order,
    and the resumed run ends where an uninterrupted one does."""
    _, g = graphs
    ckpt = tmp_path / "auto.npz"
    t = DeviceTraverser(g, _score, batch_size=8, n_score_threads=1,
                        device="cpu")
    t.prime()
    t.traverse(n_to_score=200, checkpoint_path=str(ckpt),
               checkpoint_interval=3)
    assert ckpt.exists()
    t2 = DeviceTraverser(g, _score, batch_size=8, n_score_threads=1,
                        device="cpu")
    t2.load_checkpoint(str(ckpt))
    assert t2.n_scored == t.n_scored >= 200
    assert t2.get_molecules() == t.get_molecules()
    for x in (t, t2):
        x.traverse(n_to_score=600)
    assert t2.get_molecules() == t.get_molecules()
    for x in (t, t2):
        x.shutdown()
