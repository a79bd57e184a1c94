"""rad_tpu_torch's cluster-probed build against rad_tpu's (CPU).

The partition, the probe tables and the probed candidate tables must be
array-equal to the reference's, and whole probed builds edge-identical,
in the matrix form and in the bucket form (the reference runs its Pallas
kernels in interpret mode, the port the kernels' plain twins). The port
always streams selection into the probed scan, so whatever
``stream_select`` says it must build the graph of the reference's table
path and of its streamed path. The ``gpu`` tests build the same probed
graph on the card and on the CPU, and hold the streamed build's peak
memory under the candidate tables it never allocates.
"""

import logging
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rad_tpu.build import exact as ref_exact
from rad_tpu.build import probe as ref_probe
from rad_tpu_torch.build import exact, probe
from rad_tpu_torch.build.exact import build_hnsw_exact
from rad_tpu_torch.fp.pack import popcount, popcount_rows, to_torch_packed

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "examples"))

# q_block = col_block = probe_csize = 128: 24 clusters at n = 3000
PROBED = dict(connectivity=8, seed=3, probe_csize=128, q_block=128,
              col_block=128, probe_min_n=0)


@pytest.fixture(scope="module")
def fps():
    from enrichment_example import make_library
    return make_library(3000, 128, seed=11)[0]


def _assert_same_graph(ref, port, what):
    assert ref.layer_sizes == port.layer_sizes, what
    np.testing.assert_array_equal(np.asarray(ref.keys), port.keys,
                                  err_msg=f"{what}: keys")
    for l, (a, b) in enumerate(zip(ref.neighbors, port.neighbors)):
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=f"{what}: layer {l}")


@pytest.mark.parametrize("csize,seed,n", [(256, 0, 3000), (256, 3, 3000),
                                          (128, 2, 3000), (512, 5, 1111)])
def test_bisect_clusters_array_equal(fps, csize, seed, n):
    ref = ref_probe.bisect_clusters(fps[:n], csize, seed=seed)
    # the device rows may run past n (the layer's padded upload)
    rows = to_torch_packed(np.concatenate([fps[:n], fps[:7]]), "cpu")
    port = probe.bisect_clusters(fps[:n], csize, seed=seed, dev_rows=rows)
    np.testing.assert_array_equal(port, ref, err_msg=f"{csize}/{seed}/{n}")
    np.testing.assert_array_equal(
        probe.bisect_clusters(fps[:n], csize, seed=seed), ref)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_probe_tables_array_equal(fps, use_pallas):
    """Both granularities, with the reference's probe sweeps through its
    SWAR distances or its interpret-mode matrix kernel."""
    perm = probe.bisect_clusters(fps, 256, seed=2)
    kw = dict(use_pallas=use_pallas, interpret=use_pallas)
    np.testing.assert_array_equal(
        probe.cluster_probes(fps, perm, 256, probes=5, sample=8, seed=7,
                             device="cpu"),
        ref_probe.cluster_probes(fps, perm, 256, probes=5, sample=8,
                                 seed=7, **kw))
    for q_block, sample in ((128, 8), (256, 4), (64, 16)):
        np.testing.assert_array_equal(
            probe.qblock_probes(fps, perm, 256, q_block, probes=5,
                                sample=sample, seed=9, device="cpu"),
            ref_probe.qblock_probes(fps, perm, 256, q_block, probes=5,
                                    sample=sample, seed=9, **kw),
            err_msg=f"q_block={q_block}")


@pytest.mark.parametrize("gran", ["qblock", "cluster"])
@pytest.mark.parametrize("bucket", [None, 16])
def test_probed_candidate_tables_array_equal(fps, gran, bucket):
    n, k, qb, csz = 2048, 16, 128, 256
    sub = np.ascontiguousarray(fps[:n])
    rd, ri = ref_exact._allpairs_topk_probed(
        jnp.asarray(sub), n, k, qb, csz, use_pallas=bucket is not None,
        approx_recall=0.99, bucket=bucket, interpret=True, probes=3,
        probe_sample=8, seed=5,
        pairs_per_dispatch=ref_exact.PAIRS_PER_DISPATCH,
        probe_granularity=gran)
    packed_l = to_torch_packed(sub, "cpu")
    # the tables the build never holds, made from the scan's blocks
    pd = torch.full((n + 1, k), float("inf"))
    pi = torch.full((n + 1, k), -1, dtype=torch.int32)
    for bd, ids, rows in exact._probed_blocks(
            packed_l, popcount_rows(packed_l), n, k, qb, csz, bucket, 3, 8,
            5, sub, probe_granularity=gran):
        rows = torch.where(rows >= 0, rows, n).long()
        pd[rows], pi[rows] = bd, ids
    np.testing.assert_array_equal(pd[:n].numpy(), np.asarray(rd))
    np.testing.assert_array_equal(pi[:n].numpy(), np.asarray(ri))


@pytest.mark.parametrize("gran,bucket,width", [
    ("qblock", 16, None), ("qblock", None, None), ("cluster", 16, None),
    ("cluster", None, None), ("qblock", 16, 12)])
def test_probed_build_edge_identical(fps, gran, bucket, width):
    ref = ref_exact.build_hnsw_exact(
        fps, use_pallas=True, interpret=True, block_bucket=bucket,
        probes=6, probe_granularity=gran, probe_width=width, **PROBED)
    times = {}
    port = build_hnsw_exact(fps, block_bucket=bucket, probes=6,
                            probe_granularity=gran, probe_width=width,
                            stage_times=times, device="cpu", **PROBED)
    _assert_same_graph(ref, port, f"{gran}/{bucket}/{width}")
    assert set(times) == {"candidates", "selection", "symmetrization",
                          "bisection", "probe_tables", "probed_layers"}
    assert times["probed_layers"] == [0]


def _rcp_bisect_scores(rows, pops, anchors_a, anchors_b, group_id):
    """``probe._bisect_scores`` with ``inter * (1 / union)``: two roundings
    where the divide has one, as a divide built on a reciprocal gives."""
    pops = pops.to(torch.float32)

    def dist(anchors):
        t = anchors[group_id]
        inter = popcount(rows & t).sum(-1).to(torch.float32)
        union = pops + popcount(t).sum(-1).to(torch.float32) - inter
        return 1.0 - inter * torch.reciprocal(torch.clamp(union, min=1.0))

    return dist(anchors_a) - dist(anchors_b)


def test_bisection_partition_turns_on_one_ulp_of_the_score(fps,
                                                           monkeypatch):
    """Scores that differ from the correctly rounded ones by at most one
    ulp of a distance (2^-23) give another partition: Tanimoto scores tie
    often, and a tie the stable sort broke by position is broken by value
    instead, which moves the next level's anchors. A probed graph built
    where the divide rounds differently is therefore another partition's
    graph, and is compared with this one by its recall, not edge for
    edge."""
    rows = to_torch_packed(fps, "cpu")
    pops = popcount_rows(rows)
    gid = torch.zeros(len(fps), dtype=torch.long)
    exact_s = probe._bisect_scores(rows, pops, rows[[5]], rows[[17]], gid)
    rcp_s = _rcp_bisect_scores(rows, pops, rows[[5]], rows[[17]], gid)
    assert (exact_s != rcp_s).any()
    assert float((exact_s - rcp_s).abs().max()) <= 2.0 ** -23
    perm = probe.bisect_clusters(fps, 128, seed=0)
    monkeypatch.setattr(probe, "_bisect_scores", _rcp_bisect_scores)
    other = probe.bisect_clusters(fps, 128, seed=0)
    np.testing.assert_array_equal(np.sort(other), np.sort(perm))
    cluster, other_cluster = (np.empty(len(fps), np.int64) for _ in "ab")
    cluster[perm[perm >= 0]] = np.flatnonzero(perm >= 0) // 128
    other_cluster[other[other >= 0]] = np.flatnonzero(other >= 0) // 128
    assert np.mean(perm == other) < 0.5
    assert np.mean(cluster == other_cluster) < 0.75


def test_all_layers_gated_warns_and_builds_exact(fps, caplog):
    """probes= whose every layer stays exact (the default probe_min_n of
    2M, or too few clusters) warns and gives the exact build."""
    kw = dict(connectivity=8, seed=3, q_block=128, col_block=128)
    on_cpu = dict(kw, device="cpu")
    with caplog.at_level(logging.WARNING, logger="rad_tpu_torch.build.exact"):
        times = {}
        gated = build_hnsw_exact(fps, probes=6, probe_csize=128,
                                 stage_times=times, **on_cpu)
        assert "NO layer used the probed candidate stage" in caplog.text
        assert times["probed_layers"] == []
        caplog.clear()
        few = build_hnsw_exact(fps, probes=64, probe_min_n=0, **on_cpu)
        assert "NO layer used" in caplog.text
    ref = ref_exact.build_hnsw_exact(fps, use_pallas=True, interpret=True,
                                     **kw)
    _assert_same_graph(ref, gated, "probe_min_n gate")
    _assert_same_graph(ref, few, "cluster-count gate")


def test_bucket_approx_build_agrees_with_exact():
    """The approximate-reciprocal epilogue only reorders near-ties: the
    layer-0 table agrees with the exact-epilogue build on >= 99 % of its
    slots, probed and not (256 bits: 128-bit rows tie so often that the
    exact and approximate keys straddle truncation boundaries on ~1 % of
    slots)."""
    from enrichment_example import make_library
    fps = make_library(3000, 256, seed=11)[0]
    for kw in (dict(PROBED, probes=6), dict(connectivity=8, seed=3,
                                            q_block=128, col_block=128)):
        ex = build_hnsw_exact(fps, block_bucket=16, device="cpu", **kw)
        ap = build_hnsw_exact(fps, block_bucket=16, bucket_approx=True,
                              bucket_q_tile=64, bucket_n_tile=256,
                              device="cpu", **kw)
        same = float(np.mean(ex.neighbors[0] == ap.neighbors[0]))
        assert same >= 0.99, (kw, same)
        assert ex.layer_sizes == ap.layer_sizes


def test_probed_stage_validation(fps):
    packed_l = to_torch_packed(fps[:1024], "cpu")
    pops = popcount_rows(packed_l)
    with pytest.raises(ValueError, match="multiple of q_block"):
        exact._probed_blocks(packed_l, pops, 1024, 8, 128, 192, None, 2, 4,
                             0, fps[:1024])
    with pytest.raises(ValueError, match="exceeds probe csize"):
        exact._probed_blocks(packed_l, pops, 1024, 300, 128, 256, None, 2,
                             4, 0, fps[:1024])
    with pytest.raises(ValueError, match="probe_granularity"):
        build_hnsw_exact(fps, probes=6, probe_granularity="row",
                         device="cpu", **PROBED)


# tests/test_build_probe.py::test_stream_select_bit_identical's case
STREAM = dict(connectivity=8, seed=11, q_block=128, col_block=128,
              sel_block=128, probes=3, probe_csize=256, probe_min_n=0,
              probe_sample=4)


@pytest.fixture(scope="module")
def stream_fps():
    from rad_tpu.fp import random_fingerprints
    return random_fingerprints(3000, n_bits=128, density=0.2, seed=21)


@pytest.mark.parametrize("extra", [
    {}, {"probe_granularity": "cluster"}, {"bucket_approx": True},
    {"sel_block": 512}], ids=["qblock", "cluster", "bucket_approx",
                              "sel_block_512"])
def test_stream_select_edge_identical(stream_fps, extra):
    """The port's streamed build is the graph of rad_tpu's table path and
    of its streamed path, and still splits candidates from selection."""
    kw = {**STREAM, **extra}
    times = {}
    port = build_hnsw_exact(stream_fps, stream_select=True,
                            stage_times=times, device="cpu", **kw)
    for stream in (False, True):
        ref = ref_exact.build_hnsw_exact(stream_fps, stream_select=stream,
                                         use_pallas=True, interpret=True,
                                         **kw)
        _assert_same_graph(ref, port, f"rad_tpu stream_select={stream} "
                           f"{extra}")
    assert times["probed_layers"] == [0]
    assert times["candidates"] > 0 and times["selection"] > 0


def test_stream_select_auto_rule(stream_fps, monkeypatch):
    """Every probed layer streams, whatever ``stream_select`` says, and
    no layer that does not probe streams; any other value raises."""
    calls = []
    inner = exact._select_probed

    def counted(*a, **kw):
        calls.append(a[3])          # the layer's n_pad
        return inner(*a, **kw)

    monkeypatch.setattr(exact, "_select_probed", counted)
    base = build_hnsw_exact(stream_fps, device="cpu", **STREAM)
    assert calls == [3072]          # layer 0 only: the one that probes
    for stream in (True, False):
        calls.clear()
        _assert_same_graph(base, build_hnsw_exact(
            stream_fps, stream_select=stream, device="cpu", **STREAM),
            f"stream_select={stream}")
        assert calls == [3072]
    calls.clear()
    build_hnsw_exact(stream_fps, stream_select=True, device="cpu",
                     **dict(STREAM, probe_min_n=10_000))
    assert calls == []
    with pytest.raises(ValueError, match="stream_select"):
        build_hnsw_exact(stream_fps, stream_select="always", device="cpu",
                         **STREAM)


@pytest.mark.gpu
def test_cuda_streamed_build_never_holds_the_tables():
    """At a shape where layer 0's ``[n_pad + 1, k]`` candidate tables
    (1 GiB: k = 512 over 2^18 rows of 128 bits) would outweigh every
    other buffer of the build, the probed build peaks under half of them:
    the streamed selection never allocates them. Blocks of 1,024 rows
    keep the exact layers' scans (a ``[q_block, n_pad]`` matrix and its
    sort) small too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rad_tpu.fp import random_fingerprints

    n, k = 1 << 18, 512
    fps = random_fingerprints(n, n_bits=128, density=0.2, seed=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = {}
    g = build_hnsw_exact(fps, connectivity=4, candidates=k, q_block=1024,
                         col_block=1024, sel_block=1024, probes=2,
                         probe_csize=4096, probe_min_n=0, stage_times=times,
                         device="cuda")
    peak = torch.cuda.max_memory_allocated() - base
    tables = (n + 1) * k * 8
    assert 0 in times["probed_layers"] and len(g) == n
    assert peak < tables // 2, (peak, tables)


@pytest.mark.gpu
def test_cuda_probed_build_equals_cpu_build(fps):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rad_tpu_torch.fp import kernels

    launches = (kernels.tanimoto_bucketmin.launches,
                kernels.tanimoto_matrix.launches)
    for gran in ("qblock", "cluster"):
        kw = dict(PROBED, probes=6, block_bucket=64, probe_granularity=gran)
        cpu = build_hnsw_exact(fps, device="cpu", **kw)
        gpu = build_hnsw_exact(fps, device="cuda", **kw)
        for l, (a, b) in enumerate(zip(cpu.neighbors, gpu.neighbors)):
            np.testing.assert_array_equal(a, b, err_msg=f"{gran} layer {l}")
    assert kernels.tanimoto_bucketmin.launches > launches[0]
    assert kernels.tanimoto_matrix.launches > launches[1]
