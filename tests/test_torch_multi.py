"""rad_tpu_torch's multi-campaign sweep against rad_tpu's.

The graph of ``tests/test_multi.py`` (600 rows, 128 bits, M = 4, built by
``rad_tpu.build.reference.build_hnsw`` and carried across as arrays) with three
campaigns of unequal budgets, so campaigns freeze at different steps and
the lifted merge decision fires. Every field of every campaign's final
state must be array-equal to ``rad_tpu``'s (through
``state_to_reference_arrays``), for both entry points, single- and
two-level, and each campaign must equal its solo run. All comparisons
are exact: the engines do integer bookkeeping and the scores are exact
quotients of integer counts, or table lookups.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rad_tpu.build.reference import build_hnsw
from rad_tpu.fp import random_fingerprints
from rad_tpu.fp.tanimoto import tanimoto_matrix as ref_tanimoto_matrix
from rad_tpu.traverse import device as ref_dev
from rad_tpu.traverse import multi as ref_multi
from rad_tpu_torch.fp.pack import popcount_rows, to_torch_packed
from rad_tpu_torch.fp.tanimoto import tanimoto_matrix
from rad_tpu_torch.graph.storage import HNSWGraph
from rad_tpu_torch.traverse import device as dev
from rad_tpu_torch.traverse import multi

BUDGETS = [80, 150, 120]
FRONTIER, BUFFER, BATCH = 1 << 11, 1 << 8, 4


@pytest.fixture(scope="module")
def setup():
    fps = random_fingerprints(600, n_bits=128, density=0.25, seed=41)
    ref = build_hnsw(fps, connectivity=4, expansion_add=24, seed=6)
    port = HNSWGraph(np.asarray(ref.packed), np.asarray(ref.popcounts),
                     np.asarray(ref.keys), np.asarray(ref.levels),
                     tuple(np.asarray(t) for t in ref.neighbors), ref.ndim,
                     ref.connectivity)
    targets = random_fingerprints(3, n_bits=128, density=0.25, seed=77)
    n_top = ref.layer_sizes[ref.max_level]
    r = dict(dg=ref_dev.prepare_device_graph(ref),
             packed=jnp.asarray(np.asarray(ref.packed)),
             pops=jnp.asarray(np.asarray(ref.popcounts)),
             targets=jnp.asarray(targets),
             ids=jnp.arange(n_top, dtype=jnp.int32))
    r["t_pops"] = jnp.asarray(np.bitwise_count(targets).sum(1), jnp.int32)
    r["seeds"] = ref_tanimoto_matrix(r["targets"], r["packed"][:n_top])
    r["tables"] = ref_tanimoto_matrix(r["targets"], r["packed"])
    p = dict(dg=dev.prepare_device_graph(port, "cpu"),
             packed=to_torch_packed(np.asarray(ref.packed), "cpu"),
             pops=torch.from_numpy(
                 np.asarray(ref.popcounts).astype(np.int32)),
             targets=to_torch_packed(targets, "cpu"),
             ids=torch.arange(n_top, dtype=torch.int32))
    p["t_pops"] = popcount_rows(p["targets"]).to(torch.int32)
    p["seeds"] = tanimoto_matrix(p["targets"], p["packed"][:n_top])
    p["tables"] = tanimoto_matrix(p["targets"], p["packed"])
    np.testing.assert_array_equal(p["tables"].numpy(),
                                  np.asarray(r["tables"]))
    return r, p


def _ref_start(r, dg=None, **init):
    dg = dg if dg is not None else r["dg"]
    init = dict(dict(frontier_capacity=FRONTIER, buffer_capacity=BUFFER),
                **init)
    return ref_multi.prime_multi(ref_multi.init_multi(dg, 3, **init), dg,
                                 r["ids"], r["seeds"])


def _port_start(p, dg=None, **init):
    dg = dg if dg is not None else p["dg"]
    init = dict(dict(frontier_capacity=FRONTIER, buffer_capacity=BUFFER),
                **init)
    return multi.prime_multi(multi.init_multi(dg, 3, **init), dg, p["ids"],
                             p["seeds"])


def _ref_run(r, tables: bool, budgets=BUDGETS, dg=None, **init):
    dg = dg if dg is not None else r["dg"]
    st = _ref_start(r, dg, **init)
    b = jnp.asarray(budgets, jnp.int32)
    if tables:
        return ref_multi.fused_run_multi_tables(st, dg, r["tables"], b,
                                                batch=BATCH)
    return ref_multi.fused_run_multi(st, dg, r["packed"], r["pops"],
                                     r["targets"], r["t_pops"], b,
                                     batch=BATCH)


def _port_run(p, tables: bool, budgets=BUDGETS, dg=None, **init):
    dg = dg if dg is not None else p["dg"]
    st = _port_start(p, dg, **init)
    if tables:
        return multi.fused_run_multi_tables(st, dg, p["tables"], budgets,
                                            batch=BATCH)
    return multi.fused_run_multi(st, dg, p["packed"], p["pops"],
                                 p["targets"], p["t_pops"], budgets,
                                 batch=BATCH)


def assert_campaigns_equal(port_states, ref_states):
    for i in range(3):
        got = dev.state_to_reference_arrays(
            multi.campaign_state(port_states, i))
        want = ref_multi.campaign_state(ref_states, i)
        for f in dataclasses.fields(ref_dev.TraversalState):
            np.testing.assert_array_equal(
                got[f.name], np.asarray(getattr(want, f.name)),
                err_msg=f"campaign {i}: {f.name}")


def test_prime_multi_matches_reference(setup):
    r, p = setup
    assert_campaigns_equal(_port_start(p), _ref_start(r))


@pytest.mark.parametrize("tables", [False, True],
                         ids=["targets", "tables"])
def test_multi_states_equal_reference(setup, tables):
    """Both entry points, unequal budgets: every field of every campaign
    array-equal to rad_tpu's stacked state."""
    r, p = setup
    got = _port_run(p, tables)
    assert_campaigns_equal(got, _ref_run(r, tables))
    assert (got.n_scored.numpy() >= np.asarray(BUDGETS)).all()


@pytest.mark.parametrize("init", [
    dict(buffer_capacity=64, head_capacity=32),
    dict(buffer_capacity=64, head_capacity=16, frontier_capacity=256),
], ids=["lossless", "dropping"])
def test_multi_two_level_states_equal_reference(setup, init, monkeypatch):
    """A real cold store: the lifted refill decision fires, entries spill
    to cold (and, with a 256-entry cold store, drop) and the states are
    still rad_tpu's."""
    r, p = setup
    refills = []
    refill = multi._refill_
    monkeypatch.setattr(multi, "_refill_",
                        lambda *a: refills.append(1) or refill(*a))
    budgets = [300, 420, 350]
    got = _port_run(p, False, budgets, **init)
    assert len(refills) >= 2 and int(got.cold_n.min()) > 0
    assert (int(got.n_dropped.sum()) > 0) == ("frontier_capacity" in init)
    assert_campaigns_equal(got, _ref_run(r, False, budgets, **init))


def test_multi_campaign_matches_solo_runs(setup):
    """Each campaign ends as running it alone ends: same scored set, same
    scores, same insertion order, no drops."""
    _, p = setup
    states = _port_run(p, False)
    n_top = p["ids"].shape[0]
    for i in range(3):
        solo = dev.init_state(p["dg"], frontier_capacity=FRONTIER,
                              buffer_capacity=BUFFER, head_capacity=None)
        solo = dev.prime(solo, p["dg"], p["ids"], p["seeds"][i, :n_top])
        solo = dev.fused_run(solo, p["dg"], p["packed"], p["pops"],
                             p["targets"][i], p["t_pops"][i], BUDGETS[i],
                             batch=BATCH)
        ci = multi.campaign_state(states, i)
        assert int(ci.n_scored) == int(solo.n_scored), f"campaign {i}"
        np.testing.assert_array_equal(ci.scored.numpy(),
                                      solo.scored.numpy())
        sel = solo.scored.numpy()
        np.testing.assert_array_equal(ci.scores.numpy()[sel],
                                      solo.scores.numpy()[sel])
        np.testing.assert_array_equal(dev.read_order_log(ci),
                                      dev.read_order_log(solo))
        assert int(ci.n_dropped) == 0 and int(solo.n_dropped) == 0


def test_multi_campaign_budgets_respected(setup):
    _, p = setup
    budgets = np.asarray([50, 200, 100])
    states = _port_run(p, False, budgets)
    n = states.n_scored.numpy()
    # each campaign met its budget without the slowest one dragging the
    # finished ones past theirs by more than one batch's discoveries
    assert (n >= budgets).all()
    assert (n <= budgets + BATCH * p["dg"].m0).all()
    # frozen campaigns stop counting steps
    assert len(set(states.n_steps.tolist())) > 1


def test_multi_two_level_same_scored_set(setup):
    """Two-level multi scores the same set as single-level multi at a
    lossless frontier; only the pop order of equal scores may differ."""
    _, p = setup
    budgets = [100, 160, 130]
    flat = _port_run(p, False, budgets, buffer_capacity=1 << 7)
    two = _port_run(p, False, budgets, buffer_capacity=1 << 7,
                    head_capacity=1 << 8)
    assert int(flat.n_dropped.sum()) == 0 and int(two.n_dropped.sum()) == 0
    np.testing.assert_array_equal(flat.scored.numpy(), two.scored.numpy())
    np.testing.assert_array_equal(flat.n_scored.numpy(),
                                  two.n_scored.numpy())


def test_multi_packed_adjacency_bit_identical(setup):
    """The sweep over the bit-packed neighbor table ends bit-identical to
    the int32 one."""
    _, p = setup
    dg_p = dev.pack_device_graph(p["dg"], chunk=256)
    assert dg_p.adj_bits < 32
    a = _port_run(p, False)
    b = _port_run(p, False, dg=dg_p)
    for f in dataclasses.fields(dev.TraversalState):
        np.testing.assert_array_equal(getattr(a, f.name).numpy(),
                                      getattr(b, f.name).numpy(),
                                      err_msg=f.name)


def test_multi_step_and_active_mask(setup):
    """multi_step steps the active campaigns only; stepping until the mask
    empties gives the loop's states."""
    _, p = setup
    n = p["tables"].shape[1]
    flat = p["tables"].reshape(-1)

    def score(lanes, ts):
        ok = ts >= 0
        return torch.where(
            ok, flat[lanes[:, None] * n + torch.where(ok, ts, 0).long()],
            float("inf"))

    states = _port_start(p)
    budgets = torch.tensor(BUDGETS)
    steps = 0
    while bool(multi.multi_active_mask(states, budgets).any()):
        states = multi.multi_step(states, p["dg"], BUDGETS, BATCH, score)
        steps += 1
    want = _port_run(p, True)
    assert steps == int(want.n_steps.max())
    for f in dataclasses.fields(dev.TraversalState):
        np.testing.assert_array_equal(getattr(states, f.name).numpy(),
                                      getattr(want, f.name).numpy(),
                                      err_msg=f.name)


@pytest.mark.gpu
def test_multi_cuda_equals_cpu(setup):
    """The sweep on the card (packed adjacency, two-level frontier) ends in
    the CPU run's states."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, p = setup
    kw = dict(buffer_capacity=64, head_capacity=16, frontier_capacity=256)
    budgets = [300, 420, 350]
    want = _port_run(p, True, budgets, **kw)
    c = {k: (v.to("cuda") if torch.is_tensor(v) else v)
         for k, v in p.items()}
    dg = p["dg"]
    c["dg"] = dev.pack_device_graph(dataclasses.replace(
        dg, adj=dg.adj.to("cuda"), offsets=dg.offsets.to("cuda")))
    got = _port_run(c, True, budgets, **kw)
    for f in dataclasses.fields(dev.TraversalState):
        np.testing.assert_array_equal(getattr(got, f.name).cpu().numpy(),
                                      getattr(want, f.name).numpy(),
                                      err_msg=f.name)
