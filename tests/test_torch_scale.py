"""The port's scale benchmark (``rad_tpu_torch.bench_scale``) and the
engine's id-mode state against ``benchmarks/bench_scale.py`` and
``rad_tpu.traverse.device``.

The graph generator cannot draw the reference's threefry bits, so it is
held to the reference's shape rules; the engine runs are held to the
reference's on one numpy graph and one numpy score table: the id run with
and without the ``[N]`` table and the hash run give the same order log,
``n_scored``, ``n_dropped`` and ``n_steps`` in both packages (JAX on the
CPU).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import bench_scale as ref_scale
from rad_tpu.traverse import device as ref_dev
from rad_tpu_torch import bench_scale
from rad_tpu_torch.graph.adjpack import (adj_bits_for, unpack_adjacency_rows)
from rad_tpu_torch.traverse import device as tdev

CPU = torch.device("cpu")


@pytest.mark.parametrize("n,m", [(1, 8), (7, 8), (50_000, 8), (100_000, 16),
                                 (100_000_000, 8), (240_000_000, 8),
                                 (12_345, 3)])
def test_layer_sizes_match_reference(n, m):
    assert bench_scale.hnsw_layer_sizes(n, m) == ref_scale.hnsw_layer_sizes(
        n, m)


def _check_graph(dg, sizes, n, m):
    adj = dg.adj
    if dg.adj_bits < 32:
        adj = unpack_adjacency_rows(adj, dg.m0, dg.adj_bits)
    adj = adj.numpy()
    offsets = dg.offsets_host
    assert dg.n_nodes == n and dg.m0 == 2 * m
    assert dg.n_rows == sum(sizes) and adj.shape == (dg.n_rows, 2 * m)
    assert list(offsets[:-1]) == [0, *np.cumsum(sizes)]
    assert offsets[-1] == dg.n_rows
    assert torch.equal(dg.offsets, torch.from_numpy(offsets))
    for lev, nl in enumerate(sizes):
        rows = adj[offsets[lev]:offsets[lev + 1]]
        cap = 2 * m if lev == 0 else m
        if nl == 1:
            assert (rows == -1).all(), lev
            continue
        # the columns past the layer's cap are padding; the rest hold ids
        # inside the layer, never the row's own node
        assert (rows[:, cap:] == -1).all(), lev
        ids = rows[:, :cap]
        assert ((ids >= 0) & (ids < nl)).all(), lev
        assert (ids != np.arange(nl)[:, None]).all(), lev
        # uniform draws: every id of a large layer is hit about equally
        if nl > 1000:
            counts = np.bincount(ids.ravel(), minlength=nl)
            assert abs(counts.mean() - cap) < 1e-9
            assert counts.std() < 3 * np.sqrt(cap), lev


@pytest.mark.parametrize("packed", [False, True])
def test_generated_graph_keeps_the_shape_rules(packed):
    n, m = 50_000, 8
    bits = adj_bits_for(n) if packed else None
    dg, sizes = bench_scale.make_device_graph(n, m, seed=0, n_chunks=7,
                                              packed_bits=bits, device=CPU)
    assert sizes == ref_scale.hnsw_layer_sizes(n, m)
    assert dg.adj_bits == (bits or 32)
    _check_graph(dg, sizes, n, m)
    # the chunking changes no bit; the seed does
    again, _ = bench_scale.make_device_graph(n, m, seed=0, n_chunks=7,
                                             packed_bits=bits, device=CPU)
    assert torch.equal(dg.adj, again.adj)
    other, _ = bench_scale.make_device_graph(n, m, seed=1, n_chunks=7,
                                             packed_bits=bits, device=CPU)
    assert not torch.equal(dg.adj, other.adj)
    if packed:
        plain, _ = bench_scale.make_device_graph(n, m, seed=0, n_chunks=7,
                                                 device=CPU)
        assert torch.equal(unpack_adjacency_rows(dg.adj, dg.m0, bits),
                           plain.adj)


def test_id_score_is_bit_equal():
    _, ref_id_score = ref_scale.make_id_run(8, True)
    ids = np.concatenate([np.arange(0, 70_000),
                          np.random.default_rng(0).integers(
                              0, 2**31 - 1, 200_000)]).astype(np.int32)
    want = np.asarray(ref_id_score(jnp.asarray(ids)))
    got = bench_scale.id_score(torch.from_numpy(ids)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_one_slot_score_table():
    dg, _ = bench_scale.make_device_graph(2_000, 8, seed=0, device=CPU)
    st = tdev.init_state(dg, frontier_capacity=1 << 10, buffer_capacity=256,
                         score_table=False)
    # one slot plus the dropped-write sentinel: the [N] table never exists
    assert st.scores.shape == (2,)
    full = tdev.init_state(dg, frontier_capacity=1 << 10,
                           buffer_capacity=256)
    assert full.scores.shape == (dg.n_nodes + 1,)
    assert tdev.state_to_reference_arrays(st)["scores"].shape == (1,)
    top = torch.arange(1, dtype=torch.int32)
    st = tdev.prime(st, dg, top, bench_scale.id_score(top))
    state, out = tdev.expand(st, dg, 8)
    args = (out["exp_node"], out["exp_level"], out["exp_score"],
            out["exp_valid"], out["cand"], out["to_score"],
            bench_scale.id_score(out["to_score"]))
    # the dense ops (and K1/K2, which read and write the [N] table)
    # refuse the dummy instead of indexing past its slot
    for fused in (False, True):
        with pytest.raises(ValueError, match="one-slot"):
            tdev.integrate(state, dg, *args, fused_candidates=fused)
    with pytest.raises(ValueError):
        tdev.gather_scores(state, [0])


class _IdOps(tdev.DenseStateOps):
    @staticmethod
    def gather_scores(arr, idx):
        return bench_scale.id_score(idx)

    @staticmethod
    def scatter_scores(arr, idx, vals):
        return None


def test_one_slot_table_under_fused_candidates():
    """With ops that compute scores, a one-slot state runs unfused, and
    fused_candidates=True refuses it all the same: K2 reads and writes the
    [N] table in its body, so no ops can stand in for it."""
    dg, sizes = bench_scale.make_device_graph(3_000, 8, seed=2, device=CPU)
    for fused in (False, True):
        st = _port_state(dg, sizes, bench_scale.id_score, False)
        for _ in range(6):
            st, out = tdev.expand(st, dg, 16, ops=_IdOps(),
                                  fused_candidates=fused)
            ts = out["to_score"]
            args = (st, dg, out["exp_node"], out["exp_level"],
                    out["exp_score"], out["exp_valid"], out["cand"], ts,
                    torch.where(ts >= 0, bench_scale.id_score(ts), tdev.INF))
            if fused:
                with pytest.raises(ValueError, match="fused_candidates"):
                    tdev.integrate(*args, ops=_IdOps(), fused_candidates=True)
                break
            st = tdev.integrate(*args, ops=_IdOps())
        else:
            assert int(st.n_scored) > 100


def _ref_graph(dg):
    return ref_dev.DeviceGraph(
        adj=jnp.asarray(dg.adj.numpy()),
        offsets=jnp.asarray(dg.offsets_host), n_nodes=dg.n_nodes,
        n_rows=dg.n_rows, m0=dg.m0, max_level=dg.max_level)


N_ENGINE, BUDGET, BATCH = 20_000, 3_000, 32
STATE_KW = dict(frontier_capacity=1 << 12, buffer_capacity=1 << 10,
                head_capacity=1 << 9)


def _top(sizes):
    return sizes[-1] if sizes[-1] > 1 else sizes[-2]


def _result(order, n_scored, n_dropped, n_steps):
    return dict(order=np.asarray(order), n_scored=int(n_scored),
                n_dropped=int(n_dropped), n_steps=int(n_steps))


@pytest.fixture(scope="module")
def engine_graph():
    dg, sizes = bench_scale.make_device_graph(N_ENGINE, 8, seed=3,
                                              device=CPU)
    return dg, sizes, _ref_graph(dg)


def _port_state(dg, sizes, seed_scores, score_table=True):
    st = tdev.init_state(dg, score_table=score_table, **STATE_KW)
    top = torch.arange(_top(sizes), dtype=torch.int32, device=dg.device)
    return tdev.prime(st, dg, top, seed_scores(top))


def _ref_state(rdg, sizes, seed_scores, score_table=True):
    st = ref_dev.init_state(rdg, score_table=score_table, **STATE_KW)
    top = jnp.arange(_top(sizes), dtype=jnp.int32)
    return ref_dev.prime(st, rdg, top, seed_scores(top))


@pytest.mark.parametrize("no_table", [False, True])
def test_id_run_matches_reference(engine_graph, no_table):
    dg, sizes, rdg = engine_graph
    run, id_score = bench_scale.make_id_run(BATCH, no_table)
    st = run(_port_state(dg, sizes, id_score, not no_table), BUDGET, dg)
    got = _result(tdev.read_order_log(st), st.n_scored, st.n_dropped,
                  st.n_steps)

    ref_run, ref_id = ref_scale.make_id_run(BATCH, no_table)
    rst = ref_run(_ref_state(rdg, sizes, ref_id, not no_table),
                  jnp.int32(BUDGET), rdg)
    want = _result(ref_dev.read_order_log(rst), rst.n_scored,
                   rst.n_dropped, rst.n_steps)
    assert got["n_scored"] >= BUDGET
    for key in ("n_scored", "n_dropped", "n_steps"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["order"], want["order"])
    assert len(np.unique(got["order"])) == len(got["order"])
    # the table run writes each scored id's score; the dummy holds slot 0
    ref_arrays = tdev.state_to_reference_arrays(st)
    np.testing.assert_array_equal(ref_arrays["scores"],
                                  np.asarray(rst.scores))
    np.testing.assert_array_equal(ref_arrays["scored"],
                                  np.asarray(rst.scored))


def test_hash_run_matches_reference(engine_graph):
    dg, sizes, rdg = engine_graph
    table = np.random.default_rng(1).random(N_ENGINE).astype(np.float32)
    t = torch.from_numpy(table)
    run = tdev.make_device_run(dg, torch.zeros((N_ENGINE, 1), dtype=torch.uint8),
                               t, lambda _rows, rows: rows, batch=BATCH)
    st = run(_port_state(dg, sizes, lambda top: t[top.long()]), BUDGET)
    got = _result(tdev.read_order_log(st), st.n_scored, st.n_dropped,
                  st.n_steps)

    tj = jnp.asarray(table)
    ref_run = ref_dev.make_device_run(
        rdg, jnp.zeros((N_ENGINE, 1), jnp.uint8), tj,
        lambda _rows, rows: rows, batch=BATCH)
    rst = ref_run(_ref_state(rdg, sizes, lambda top: tj[top]),
                  jnp.int32(BUDGET))
    want = _result(ref_dev.read_order_log(rst), rst.n_scored,
                   rst.n_dropped, rst.n_steps)
    for key in ("n_scored", "n_dropped", "n_steps"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["order"], want["order"])


@pytest.mark.parametrize("extra", [["--mode", "hash"],
                                   ["--mode", "id", "--no-score-table"],
                                   ["--mode", "fps", "--packed-adj"]])
def test_main_on_the_cpu(capsys, extra):
    result = {}
    rc = bench_scale.main(["--n", "30000", "--budget", "2000", "--batch",
                           "32", "--frontier", "4096", "--buffer", "1024",
                           "--runs", "1", "--device", "cpu", *extra],
                          result=result)
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "scale_traversal_nodes_per_sec"
    for key in ("value", "unit", "n", "mode", "budget", "batch", "m",
                "packed_adj_bits"):
        assert key in rec, key
    assert rec["runs"][0]["n_scored"] >= 2000
    assert rec["order_log_distinct"]
    st = result["state"]
    if "--no-score-table" in extra:
        assert st.scores.shape == (2,)
        assert rec["state_bytes"]["scores"] == 8
    assert rec["state_bytes"] == bench_scale.tensor_bytes(st)


def test_no_score_table_needs_id_mode():
    with pytest.raises(SystemExit):
        bench_scale.main(["--mode", "hash", "--no-score-table",
                          "--device", "cpu"])


def test_cuda_device_is_the_default_and_refused_without_one(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    assert bench_scale.main(["--n", "1000"]) == 1
    assert "nothing measured" in capsys.readouterr().err


@pytest.mark.gpu
def test_cuda_id_run_matches_the_cpu(engine_graph):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dg, sizes, _ = engine_graph
    gpu = dataclasses.replace(dg, adj=dg.adj.cuda(),
                              offsets=dg.offsets.cuda())
    outs = []
    for g in (dg, gpu):
        run, id_score = bench_scale.make_id_run(BATCH, True)
        st = run(_port_state(g, sizes, id_score, False), BUDGET, g)
        outs.append(tdev.read_order_log(st))
    np.testing.assert_array_equal(outs[0], outs[1])
