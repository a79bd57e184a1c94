"""rad_tpu_torch's host-scored pod engine against rad_tpu's (CPU).

The 8 cases of ``tests/test_pod_host_scoring.py`` on both packages: the
graph of that file (600 rows, 128 bits, M = 6, built by
``rad_tpu.build.reference.build_hnsw`` and carried across as arrays)
split over the reference's 8 virtual CPU devices and over the port's
single-controller mesh of ``[cpu] * 8``, scored on the host by a
deterministic stand-in for a docking program.

Bars: at ``pipeline_depth=1`` the pod's order log, scores and scored
count array-equal to the single-device host-scored engine of both
packages and to the reference's pod; at depth 4 a duplicate-free scored set with
every score the scoring function's; the sharded-state layout's order
equal to the replicated one's; checkpoints resume to the same order.
"""

import numpy as np
import pytest
import torch

from rad_tpu.build.reference import build_hnsw
from rad_tpu.fp import random_fingerprints
from rad_tpu.parallel import make_mesh as ref_make_mesh
from rad_tpu.parallel.pod import PodTraverser as RefPod
from rad_tpu.traverse.device import read_order_log as ref_read_order_log
from rad_tpu.traverse.driver import DeviceTraverser as RefDeviceTraverser
from rad_tpu_torch.graph.storage import HNSWGraph
from rad_tpu_torch.parallel import make_mesh
from rad_tpu_torch.parallel.pod import PodTraverser
from rad_tpu_torch.parallel.sharded import sharded_state_to_reference_arrays
from rad_tpu_torch.traverse.device import read_order_log
from rad_tpu_torch.traverse.driver import DeviceTraverser

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes():
    return ref_make_mesh(8), make_mesh(8, devices=[CPU] * 8)


@pytest.fixture(scope="module")
def built():
    fps = random_fingerprints(600, n_bits=128, density=0.25, seed=11)
    ref = build_hnsw(fps, connectivity=6, expansion_add=32, seed=1)
    port = HNSWGraph(np.asarray(ref.packed), np.asarray(ref.popcounts),
                     np.asarray(ref.keys), np.asarray(ref.levels),
                     tuple(np.asarray(t) for t in ref.neighbors), ref.ndim,
                     ref.connectivity)
    return ref, port


def scoring_fn(smiles: str) -> float:
    # deterministic stand-in for a docking program (the SMILES is the key
    # as a string when no store is attached)
    k = int(smiles)
    return float((1103515245 * k + 12345) % 99991) / 99991.0


def test_pod_host_scoring_bit_identical(meshes, built):
    (rm, pm), (ref, port) = meshes, built
    n_to_score = 200      # cut from the reference case's 300
    runs = []
    for make in (lambda: RefDeviceTraverser(ref, scoring_fn, batch_size=16,
                                            n_score_threads=4),
                 lambda: RefPod(ref, scoring_fn=scoring_fn, mesh=rm,
                                batch_size=16, n_score_threads=4),
                 lambda: DeviceTraverser(port, scoring_fn, batch_size=16,
                                         n_score_threads=4, device="cpu"),
                 lambda: PodTraverser(port, scoring_fn=scoring_fn, mesh=pm,
                                      batch_size=16, n_score_threads=4)):
        t = make()
        t.prime()
        stats = t.traverse(n_to_score=n_to_score)
        runs.append(t)
    assert stats["termination_reason"] == "n_to_score"
    r_dev, r_pod, p_dev, pod = runs
    order = read_order_log(pod.state)
    for other in (r_dev, r_pod):
        np.testing.assert_array_equal(order, ref_read_order_log(other.state))
        np.testing.assert_array_equal(
            sharded_state_to_reference_arrays(pod.state)["scores"],
            np.asarray(other.state.scores))
    np.testing.assert_array_equal(order, read_order_log(p_dev.state))
    assert pod.n_scored == p_dev.n_scored == r_pod.n_scored
    assert pod.get_molecules() == r_pod.get_molecules()
    for t in runs:
        t.shutdown()


def test_pod_host_scoring_pipelined_set_agrees(meshes, built):
    """pipeline_depth=4: the order may interleave, but the scored set is
    duplicate-free, every score is the scoring function's, and the set is
    the reference pod's at the same depth."""
    (rm, pm), (ref, port) = meshes, built
    sets = []
    for cls, g, m in ((RefPod, ref, rm), (PodTraverser, port, pm)):
        pt = cls(g, scoring_fn=scoring_fn, mesh=m, batch_size=16,
                 n_score_threads=4)
        pt.prime()
        pt.traverse(n_to_score=300, pipeline_depth=4)
        mols = pt.get_molecules()
        ids = [x[0] for x in mols]
        assert len(ids) == len(set(ids)), "duplicate scoring"
        assert len(ids) >= 300
        for i, s, smi in mols:
            assert s == np.float32(scoring_fn(smi))
        sets.append(set(ids))
        pt.shutdown()
    assert sets[0] == sets[1]


def test_pod_host_scoring_sharded_state_agrees(meshes, built):
    """scored/scores/enqueued split by rows: the same order and count as
    the replicated layout, in both packages."""
    (rm, pm), (ref, port) = meshes, built
    orders = []
    for cls, g, m, read in ((RefPod, ref, rm, ref_read_order_log),
                            (PodTraverser, port, pm, read_order_log)):
        for shard_state in (False, True):
            t = cls(g, scoring_fn=scoring_fn, mesh=m, batch_size=16,
                    shard_state=shard_state)
            t.prime()
            t.traverse(n_to_score=200)
            orders.append((np.asarray(read(t.state)), t.n_scored))
            t.shutdown()
    for o, n in orders[1:]:
        np.testing.assert_array_equal(o, orders[0][0])
        assert n == orders[0][1]


def test_host_mode_results_carry_smiles(meshes, built):
    (rm, pm), (ref, port) = meshes, built
    got = []
    for cls, g, m in ((RefPod, ref, rm), (PodTraverser, port, pm)):
        pt = cls(g, scoring_fn=scoring_fn, mesh=m, batch_size=8)
        pt.prime()
        pt.traverse(n_to_score=50)
        best = pt.get_best_molecules(5)
        assert len(best) == 5 and all(len(t) == 3 for t in best)
        assert best == sorted(best, key=lambda t: t[1])
        got.append(best)
        pt.shutdown()
    assert got[0] == got[1]


def test_ctor_validation(meshes, built):
    _, pm = meshes
    _, port = built
    with pytest.raises(ValueError, match="exactly one"):
        PodTraverser(port, mesh=pm)                       # neither scorer
    with pytest.raises(ValueError, match="exactly one"):
        PodTraverser(port, target_packed=np.asarray(port.packed)[0],
                     scoring_fn=scoring_fn, mesh=pm)      # both


def test_pod_deployment_mode_via_radtraverser(meshes, built):
    """RADTraverser(deployment_mode='pod') runs the whole lifecycle over
    the sharded engine, with its state views and stats, as the
    reference's does."""
    from rad_tpu import create_pod_traverser as ref_create
    from rad_tpu_torch import create_pod_traverser

    (rm, pm), (ref, port) = meshes, built
    got = []
    for create, g, m in ((ref_create, ref, rm),
                         (create_pod_traverser, port, pm)):
        t = create(g, scoring_fn, mesh=m, batch_size=16)
        t.prime()
        stats = t.traverse(n_to_score=150)
        assert stats["n_scored"] >= 150
        best = t.get_best_molecules(10)
        assert len(best) == 10 and best == sorted(best, key=lambda x: x[1])
        assert len(t.scored_set) >= 150
        ts = t.get_traversal_stats()
        assert ts["deployment_mode"] == "pod" and ts["engine"] == "pod"
        got.append((best, len(t.scored_set), len(t.priority_queue),
                    t.scored_set.getScore(best[0][0]),
                    ts["device"]["n_devices"]))
        t.shutdown()
    assert got[0] == got[1]
    with pytest.raises(TypeError, match="local graph"):
        create_pod_traverser(object(), scoring_fn, mesh=pm)


def test_pod_checkpoint_resume(meshes, built, tmp_path):
    """A checkpoint resumes to the uninterrupted run's order, with the
    state replicated or split; the file is rad_tpu's layout, so the
    reference's pod resumes it too."""
    (rm, pm), (ref, port) = meshes, built
    for shard_state in (False, True):
        a = PodTraverser(port, scoring_fn=scoring_fn, mesh=pm, batch_size=16,
                         shard_state=shard_state)
        a.prime()
        a.traverse(n_to_score=120)
        p = str(tmp_path / f"pod_{shard_state}.ckpt")
        a.save_checkpoint(p)
        n_a = a.n_scored
        a.traverse(n_to_score=300)
        b = PodTraverser(port, scoring_fn=scoring_fn, mesh=pm, batch_size=16,
                         shard_state=shard_state)
        b.load_checkpoint(p)
        assert b.n_scored == n_a
        b.traverse(n_to_score=300)
        np.testing.assert_array_equal(read_order_log(a.state),
                                      read_order_log(b.state))
        a.shutdown()
        b.shutdown()
    r = RefPod(ref, scoring_fn=scoring_fn, mesh=rm, batch_size=16,
               shard_state=True)
    r.load_checkpoint(p)
    assert r.n_scored == n_a
    r.traverse(n_to_score=300)
    np.testing.assert_array_equal(ref_read_order_log(r.state),
                                  read_order_log(a.state))
    r.shutdown()
    from rad_tpu_torch.build.reference import build_hnsw as port_build
    small = port_build(random_fingerprints(100, n_bits=128, density=0.25,
                                           seed=2), connectivity=6,
                       expansion_add=16, seed=1)
    with pytest.raises(ValueError, match="different graph"):
        PodTraverser(small, scoring_fn=scoring_fn, mesh=pm,
                     shard_state=True).load_checkpoint(p)


def test_scoring_bridge_keeps_virtual_keys_lazy():
    """HostScoringBridge keeps a virtual key map (a v2 slim graph's
    8 B/node keys) virtual and indexes it per batch."""
    from rad_tpu_torch.graph.storage import ArangeKeys
    from rad_tpu_torch.traverse.pipeline import HostScoringBridge

    bridge = HostScoringBridge(ArangeKeys(1000), scoring_fn,
                               n_score_threads=1)
    assert isinstance(bridge.keys, ArangeKeys)
    assert bridge.smiles_for_ids(np.array([3, 7])) == ["3", "7"]
    scores = bridge.score_batch(np.array([5, -1, 9], np.int32))
    assert scores.shape == (3,)
    assert scores[0] == pytest.approx(scoring_fn("5"))
    assert scores[1] == pytest.approx(scoring_fn("9"))  # packed left
    bridge.shutdown()
