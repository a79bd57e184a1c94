"""``python -m rad_tpu_torch.bench_recall`` against
``benchmarks/bench_recall.py``, and the sequential tree library both draw
against ``examples/enrichment_example.py:make_library``.

Both mains measure one graph: the port builds it and saves it
(``--graph-cache``), then each package's main loads the same file, and the
recalls
(ids of the beam search against the brute-force truth, in both packages)
must be equal at every ef. The reference's line has its keys, and the
port's those plus ``"builder"``.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from benchmarks import bench_recall as ref_bench
from rad_tpu_torch import bench_recall
from rad_tpu_torch.synthetic import make_library_sequential

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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



def _enrichment_example():
    path = os.path.join(REPO, "examples", "enrichment_example.py")
    spec = importlib.util.spec_from_file_location("enrichment_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,n_bits,seed", [(500, 512, 0), (500, 1024, 3)])
def test_sequential_library_matches_example(n, n_bits, seed):
    want = _enrichment_example().make_library(n, n_bits, seed=seed)
    got = make_library_sequential(n, n_bits, seed=seed)
    assert got[0].dtype == np.uint32 and got[0].shape == (n, n_bits // 32)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("builder,n", [("exact", 1500), ("host", 300),
                                       ("device", 600), ("native", 1500)])
def test_recalls_equal_the_reference_on_one_graph(tmp_path, capsys, builder,
                                                  n):
    cache = str(tmp_path / "g.npz")
    common = ["--n", str(n), "--q", "64", "--efs", "16", "64",
              "--chain", "1", "--graph-cache", cache]
    assert bench_recall.main(common + ["--builder", builder,
                                       "--device", "cpu"]) == 0
    built = _last_json(capsys)
    assert built["builder"] == builder
    assert os.path.exists(cache)
    # a run from the cache draws its queries from the graph's rows (node
    # order), the run that built it from the library's, in both packages
    assert bench_recall.main(common + ["--device", "cpu"]) == 0
    port = _last_json(capsys)
    assert port["builder"] == "cache"
    assert ref_bench.main(common) == 0
    ref = _last_json(capsys)

    assert set(built) == set(port) == set(ref) | {"builder"}
    for key in ("metric", "n", "connectivity", "expansion_add"):
        assert port[key] == ref[key] == built[key], key
    assert [r["ef"] for r in port["results"]] == [16, 64]
    for a, b in zip(port["results"], ref["results"]):
        assert set(a) == set(b)
        assert a["ef"] == b["ef"]
        assert a["recall"] == b["recall"], (a, b)
        assert a["qps"] > 0 and a["qps_chained"] > 0


def test_uniform_library_and_queries_match_the_reference():
    from rad_tpu.fp import random_fingerprints

    fps, q = bench_recall.load_fingerprints("uniform", 700, 256, 16)
    np.testing.assert_array_equal(
        fps, random_fingerprints(700, n_bits=256, density=0.1, seed=0))
    np.testing.assert_array_equal(
        q, random_fingerprints(16, n_bits=256, density=0.1, seed=99))
    fps_t, q_t = bench_recall.load_fingerprints("tree", 300, 256, 16)
    want = _enrichment_example().make_library(300, 256, seed=0)[0]
    np.testing.assert_array_equal(fps_t, want)
    idx = np.random.default_rng(99).choice(300, 16, replace=False)
    np.testing.assert_array_equal(q_t, want[idx])


def test_builder_is_refused_by_name(monkeypatch):
    """The native builder (the default, as in the reference) is the
    reference's at one thread, edge for edge; a builder the port does not
    have is refused by name."""
    import functools

    from rad_tpu.native import build_hnsw_native
    from rad_tpu_torch import native
    from test_torch_reference import _assert_same_graph

    monkeypatch.setattr(native, "build_hnsw_native", functools.partial(
        native.build_hnsw_native, n_threads=1))
    fps, _ = bench_recall.load_fingerprints("tree", 400, 256, 16)
    got = bench_recall.build_graph("native", fps, 8, 64,
                                   torch.device("cpu"))
    _assert_same_graph(build_hnsw_native(fps, connectivity=8,
                                         expansion_add=64, seed=0,
                                         n_threads=1), got, "native")
    with pytest.raises(ValueError, match="builder"):
        bench_recall.build_graph("gpu", np.zeros((4, 8), np.uint32), 16,
                                 64, torch.device("cpu"))


def test_cuda_device_is_the_default_and_refused_without_one(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    assert bench_recall.main(["--n", "100"]) == 1
    assert "nothing measured" in capsys.readouterr().err
