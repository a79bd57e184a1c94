"""``python -m rad_tpu_torch.bench_probe_sweep`` against the reference's
sweep (``benchmarks/bench_probe_sweep.py``).

The reference's evaluation is nested in its ``main`` and drives a remote
device, so the test takes its recipe: the probed build
``rad_tpu.build.exact.build_hnsw_exact`` (``use_pallas=True,
interpret=True``: off a TPU the reference's exact builder otherwise takes
its XLA path, which is another graph), then member queries (rng 17), the
blocked brute-force truth in keys and ``rad_tpu.search.knn.search_device``,
with the reference's edge-recall and recall formulas. On one library the
port's point gives the same numbers.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rad_tpu.build.exact import build_hnsw_exact as ref_build
from rad_tpu.chem import morgan_fingerprints_packed as ref_morgan
from rad_tpu.chem.library import make_smiles_library as ref_smiles
from rad_tpu.fp.tanimoto import bruteforce_topk_blocked as ref_truth
from rad_tpu.search.knn import search_device as ref_search
from rad_tpu_torch import bench_probe_sweep as sweep
from rad_tpu_torch.synthetic import make_library

CPU = torch.device("cpu")
N, CSIZE, PROBES, RECALL = 2048, 128, 4, 200
SMALL = dict(q_block=CSIZE, col_block=CSIZE, sel_block=CSIZE)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file: the tier-1 lane runs several
    workers at once, and a pool of every core per worker makes the port's
    many small CPU operations (the beam search's host loop above all) wait
    on each other, ~10x slower than one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _reference_point(fps, qidx, efs, width):
    """bench_probe_sweep.py's eval_recall of its one_build, on the CPU."""
    g = ref_build(fps, connectivity=16, seed=0, probes=PROBES,
                  probe_csize=CSIZE, probe_sample=16,
                  probe_granularity="qblock", probe_width=width,
                  probe_min_n=0, use_pallas=True, interpret=True, **SMALL)
    n = len(fps)
    keys = np.asarray(g.keys)
    q = np.ascontiguousarray(fps[qidx])
    _, i_t = ref_truth(jnp.asarray(q), g.packed, 10)
    truth = keys[np.maximum(np.asarray(i_t), 0)]
    row_of = np.empty(n, np.int64)
    row_of[keys] = np.arange(n)
    adj = np.asarray(g.neighbors[0][jnp.asarray(row_of[qidx])])
    adj_orig = np.where(adj >= 0, keys[np.maximum(adj, 0)], -1)
    out = {"edge_recall_at_10": round(float(np.mean([
        len((set(adj_orig[r].tolist()) | {qidx[r]})
            & set(truth[r].tolist())) / 10.0
        for r in range(len(qidx))])), 4)}
    for ef in efs:
        _, i_s = ref_search(g, q, k=10, expansion_search=ef)
        i_s = np.asarray(i_s)
        i_s = np.where(i_s >= 0, keys[np.maximum(i_s, 0)], -1)
        out[f"recall_at_10_ef{ef}"] = float(np.mean([
            len(set(i_s[r].tolist()) & set(truth[r].tolist())) / 10.0
            for r in range(len(qidx))]))
    return g, out


@pytest.mark.parametrize("width", [16])
def test_qblock_point_equals_the_reference(width):
    fps, _ = make_library(N, 1024, seed=0)
    qidx = sweep.member_queries(N, RECALL)
    np.testing.assert_array_equal(
        qidx, np.random.default_rng(17).choice(N, size=RECALL,
                                               replace=False))
    times = {}
    g, dt = sweep.one_build(fps, "qblock", PROBES, width, csize=CSIZE,
                            device=CPU, stage_times=times, **SMALL)
    assert dt > 0 and 0 in times["probed_layers"]
    got = sweep.RecallEval(fps, qidx, [16, 64], CPU)(g)
    ref_g, want = _reference_point(fps, qidx, [16, 64], width)
    for a, b in zip(g.neighbors, ref_g.neighbors):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got == want
    # the padded probe lists give the unpadded build's graph
    unpadded, _ = sweep.one_build(fps, "qblock", PROBES, None, csize=CSIZE,
                                  device=CPU, **SMALL)
    for a, b in zip(g.neighbors, unpadded.neighbors):
        np.testing.assert_array_equal(a, b)


def test_exact_point_is_the_all_pairs_build():
    fps, _ = make_library(1024, 256, seed=2)
    g, _ = sweep.one_build(fps, "exact", 0, 64, csize=CSIZE, device=CPU,
                           stage_times={}, **SMALL)
    ref_g = ref_build(fps, connectivity=16, seed=0, use_pallas=True,
                      interpret=True, **SMALL)
    for a, b in zip(g.neighbors, ref_g.neighbors):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_seed_moves_the_partition_not_the_truth():
    fps, _ = make_library(N, 256, seed=0)
    qidx = sweep.member_queries(N, 64)
    ev = sweep.RecallEval(fps, qidx, [32], CPU)
    graphs = [sweep.one_build(fps, "qblock", PROBES, None, csize=CSIZE,
                              seed=s, device=CPU, **SMALL)[0]
              for s in (0, 1)]
    ev(graphs[0])
    truth = ev.truth.copy()
    ev(graphs[1])
    np.testing.assert_array_equal(ev.truth, truth)
    assert any(not np.array_equal(a, b) for a, b in
               zip(graphs[0].neighbors, graphs[1].neighbors))


def test_morgan_library_is_the_in_tree_morgan(tmp_path):
    n = 300
    fps = sweep.load_library(n, 1024, kind="morgan", processes=2,
                             cache_dir=str(tmp_path))
    smiles, _ = ref_smiles(n, seed=0)
    np.testing.assert_array_equal(fps, ref_morgan(smiles, radius=2,
                                                  n_bits=1024))
    assert os.path.exists(tmp_path / f"morgan_ecfp_lib_n{n}_b1024.npy")
    # the pool and one process give one array
    np.testing.assert_array_equal(
        sweep.morgan_fingerprints_parallel(smiles, processes=1, chunk=64),
        sweep.morgan_fingerprints_parallel(smiles, processes=3, chunk=64))


def test_batched_library_is_the_reference_draw(tmp_path):
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "enrichment_example.py")
    spec = importlib.util.spec_from_file_location("enrichment_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fps = sweep.load_library(400, 512, cache_dir=str(tmp_path))
    np.testing.assert_array_equal(fps, mod.make_library(400, 512, seed=0)[0])
    assert os.path.exists(tmp_path / "bes_lib_n400_b512_s0.npy")
    # past 2M rows the batched recipe (batch 2^20) would run: checked
    # against make_library_batched by tests/test_torch_synthetic.py


def test_main_writes_every_point(tmp_path, capsys):
    n = 1024
    fps, _ = make_library(n, 64, seed=0)
    np.save(tmp_path / f"bes_lib_n{n}_b64_s0.npy", fps)
    results = tmp_path / "r.jsonl"
    rc = sweep.main(["--n", str(n), "--n-bits", "64", "--csize", "4096",
                     "--sweep", "exact:0,qblock:1", "--recall", "64",
                     "--ef", "16", "--results", str(results),
                     "--throughput", "exact:0", "--seed", "2",
                     "--save", str(tmp_path / "g.npz"),
                     "--cache-dir", str(tmp_path), "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    lines = [json.loads(x) for x in results.read_text().splitlines()]
    assert out["metric"] == "probe_sweep" and out["results"] == lines
    assert [r["kind"] for r in lines] == ["sweep", "sweep", "throughput",
                                          "save"]
    assert all(r["seed"] == 2 and r["library"] == "batched" for r in lines)
    # 1,024 rows make one 4,096-row cluster: the qblock:1 request probes no
    # layer, and its record says so
    assert lines[0]["probed_layers"] == [] and lines[1]["probed_layers"] == []
    for r in lines[:3]:
        assert set(r) >= {"edge_recall_at_10", "recall_at_10_ef16",
                          "build_s"}
        assert 0 < r["recall_at_10_ef16"] <= 1
    assert lines[1]["edge_recall_at_10"] == lines[0]["edge_recall_at_10"]
    assert os.path.exists(tmp_path / "g.npz")


def test_cuda_device_is_the_default_and_refused_without_one(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    assert sweep.main(["--n", "100"]) == 1
    assert "nothing measured" in capsys.readouterr().err
