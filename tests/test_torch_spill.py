"""rad_tpu_torch's host-spilled order log against rad_tpu's.

The cases of ``tests/test_spill.py`` on the port (RAM and file, read
slicing, truncate, the stale-tail trim on ``load_checkpoint``), and the
spilled order of a traverser whose device ring (64 ids) is far below the
scored count held to ``rad_tpu``'s ``DeviceTraverser(order_log_spill=True)``
on the same graph and scorer. Orders are integer ids: every comparison is
exact.
"""

import numpy as np
import pytest

from rad_tpu.build.reference import build_hnsw
from rad_tpu.fp import random_fingerprints
from rad_tpu.store.smiles_store import InMemorySmilesStore as RefStore
from rad_tpu.traverse.driver import DeviceTraverser as RefTraverser
from rad_tpu_torch.graph.storage import HNSWGraph
from rad_tpu_torch.store import InMemorySmilesStore
from rad_tpu_torch.traverse.driver import DeviceTraverser
from rad_tpu_torch.traverse.spill import SpilledOrderLog


@pytest.fixture(scope="module")
def setup():
    n = 250
    fps = random_fingerprints(n, n_bits=64, density=0.3, seed=19)
    ref = build_hnsw(fps, connectivity=4, expansion_add=20, seed=6)
    graph = HNSWGraph(np.asarray(ref.packed), np.asarray(ref.popcounts),
                      np.asarray(ref.keys), np.asarray(ref.levels),
                      tuple(np.asarray(t) for t in ref.neighbors), ref.ndim,
                      ref.connectivity)
    keys = np.asarray(ref.keys)
    rng = np.random.default_rng(2)
    table = {int(k): float(s)
             for k, s in zip(keys, rng.permutation(n).astype(float))}
    smiles = {int(k): f"P_{int(k)}" for k in keys}

    def scoring_fn(s):
        return table[int(s.split("_")[1])]

    return ref, graph, smiles, scoring_fn


def _run(setup, **kw):
    _, graph, smiles, scoring_fn = setup
    tr = DeviceTraverser(graph, scoring_fn, InMemorySmilesStore(smiles),
                         batch_size=4, frontier_capacity=1 << 12,
                         n_score_threads=1, device="cpu", **kw)
    tr.prime()
    tr.traverse(n_to_score=10**9, timeout=120, pipeline_depth=1)
    mols = tr.get_molecules()
    best = tr.get_best_molecules(20)
    tr.shutdown()
    return tr, [m[0] for m in mols], best


def test_spilled_order_matches_unbounded_ring(setup):
    _, order_full, best_full = _run(setup)         # ring = N (lossless)
    tr, order_spill, best_spill = _run(setup, log_capacity=64,
                                       order_log_spill=True)
    assert len(order_full) >= 0.95 * len(setup[1])   # near-total sweep
    assert order_spill == order_full
    assert best_spill == best_full
    # the device ring really was undersized (64 ids + the sentinel slot)
    assert tr.state.order_log.shape[0] == 64 + 1
    assert tr.n_scored > 64


def test_spilled_order_matches_reference_traverser(setup):
    ref, _, smiles, scoring_fn = setup
    want = RefTraverser(ref, scoring_fn, RefStore(smiles), batch_size=4,
                        frontier_capacity=1 << 12, n_score_threads=1,
                        log_capacity=64, order_log_spill=True)
    want.prime()
    want.traverse(n_to_score=10**9, timeout=120, pipeline_depth=1)
    ref_mols = want.get_molecules()
    want.shutdown()
    _, order_spill, _ = _run(setup, log_capacity=64, order_log_spill=True)
    assert order_spill == [m[0] for m in ref_mols]
    assert len(order_spill) > 64


def test_spill_to_file(setup, tmp_path):
    path = str(tmp_path / "order.i32")
    _, order_full, _ = _run(setup)
    _, order_spill, _ = _run(setup, log_capacity=64, order_log_spill=path)
    assert order_spill == order_full
    on_disk = np.fromfile(path, dtype="<i4")
    np.testing.assert_array_equal(on_disk, np.asarray(order_full))
    # resumable: a new log over the same file starts at the file length
    log = SpilledOrderLog(path)
    assert len(log) == log.seen == len(order_full)
    np.testing.assert_array_equal(log.read(), on_disk)


def test_spilled_log_read_slicing():
    log = SpilledOrderLog()
    log.append(np.arange(10, dtype=np.int32))
    log.append(np.arange(10, 25, dtype=np.int32))
    assert len(log) == 25
    np.testing.assert_array_equal(log.read(), np.arange(25))
    np.testing.assert_array_equal(log.read(5, 10), np.arange(5, 15))
    np.testing.assert_array_equal(log.read(20), np.arange(20, 25))
    assert SpilledOrderLog().read().size == 0


def test_truncate_ram_and_file(tmp_path):
    ram = SpilledOrderLog()
    ram.append(np.arange(10, dtype=np.int32))
    ram.append(np.arange(10, 20, dtype=np.int32))
    ram.truncate(7)
    assert len(ram) == 7
    assert ram.read().tolist() == list(range(7))
    ram.truncate(100)  # no-op beyond length
    assert len(ram) == 7

    path = str(tmp_path / "order.bin")
    f = SpilledOrderLog(path)
    f.append(np.arange(20, dtype=np.int32))
    f.truncate(5)
    assert len(f) == 5
    assert f.read().tolist() == list(range(5))
    # a resumed log sees the truncated length
    assert len(SpilledOrderLog(path)) == 5


def test_drain_raises_when_the_ring_overran(setup):
    """More new ids than the ring holds since the last drain cannot be
    recovered: the drain says so instead of returning a wrong order."""
    tr, order, _ = _run(setup, log_capacity=64)
    assert len(order) == 64  # without a spill only the ring's tail is left
    with pytest.raises(RuntimeError, match="overran"):
        SpilledOrderLog().drain(tr.state)


def test_load_checkpoint_trims_stale_spill(setup, tmp_path):
    """Resuming from a checkpoint truncates spill entries the earlier run
    wrote beyond the checkpoint's n_scored."""
    _, graph, smiles, scoring_fn = setup
    spill_path = str(tmp_path / "order_resume.bin")
    ckpt = str(tmp_path / "state.npz")
    kw = dict(batch_size=4, frontier_capacity=1 << 12, n_score_threads=1,
              log_capacity=64, order_log_spill=spill_path, device="cpu")
    tr = DeviceTraverser(graph, scoring_fn, InMemorySmilesStore(smiles), **kw)
    tr.prime()
    tr.traverse(n_to_score=40, timeout=120)
    tr.save_checkpoint(ckpt)
    n_at_ckpt = tr.n_scored
    tr.traverse(n_to_score=120, timeout=120)  # runs past the checkpoint
    assert len(tr._spill) > n_at_ckpt
    order = [m[0] for m in tr.get_molecules()]
    tr.shutdown()

    tr2 = DeviceTraverser(graph, scoring_fn, InMemorySmilesStore(smiles),
                          **kw)
    tr2.load_checkpoint(ckpt)
    assert len(tr2._spill) == tr2.n_scored == n_at_ckpt
    # and the resumed run writes the same order again
    tr2.traverse(n_to_score=120, timeout=120)
    assert [m[0] for m in tr2.get_molecules()] == order
    tr2.shutdown()
