"""rad_tpu_torch's native host path against rad_tpu's (CPU, g++).

Both packages compile the same ``hnsw_builder.cpp`` (the copy is pinned
byte for byte), so on the same seeded numpy input each public function
must give what ``rad_tpu.native``'s gives:

* single-threaded builds edge-identical to the reference's and to the
  port's numpy builder (two single-threaded runs agreeing first);
  multithreaded builds (4 threads, whose graph depends on thread timing)
  held to the graph invariants and to recall@10 against brute force;
* the host search, the brute force and the batch fingerprinter
  array-equal to the reference's (fingerprints also to the Python path,
  at a width off the 32-bit word, radius 1 and 2, empty and non-ASCII
  strings, an empty batch), and ``smiles_fingerprints`` seen to hand a
  batch of 65 to the native path;
* every caller's native path: ``HNSWIndex.build`` / ``search``,
  ``build_hnsw_partitioned`` with ``"native"`` and ``"auto"`` and the
  index CLI (``bench_recall`` and ``bench_prefix`` in their own files);
* the loader: the build directory's override, the digest in the
  library's name, a library another user owns refused, and a failed
  compile raising the compiler's message where native is asked for by
  name, while ``"auto"`` and the batch dispatch take the host path.

Every call names its threads: 1 for exactness, at most 4 elsewhere, so
that several test workers do not oversubscribe the host's cores. Torch
runs on one thread in this file, as in the other files of the port's
host layers.
"""

import functools
import hashlib
import os

import numpy as np
import pytest
import torch

import rad_tpu
import rad_tpu.native as ref_native
from rad_tpu.build import partition as ref_partition
from rad_tpu.fp import pack as ref_pack
from rad_tpu_torch import HNSWIndex, native
from rad_tpu_torch.build import partition
from rad_tpu_torch.build.reference import build_hnsw
from rad_tpu_torch.fp import pack
from rad_tpu_torch.fp.pack import random_fingerprints
from rad_tpu_torch.fp.tanimoto import bruteforce_topk
from rad_tpu_torch.search.knn import search_device
from test_torch_reference import _assert_same_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMILES = ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "N", "",
          "CCCCCCCCCCCCCCCC", "C[C@H](N)C(=O)O", "CCé", "☃C(=O)N",
          "[13CH4]", "c1ccc2ccccc2c1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fps():
    return random_fingerprints(800, n_bits=256, density=0.2, seed=23)


@pytest.fixture(scope="module")
def graph(fps):
    """One single-threaded native graph, the same in both packages."""
    return native.build_hnsw_native(fps, connectivity=8, expansion_add=64,
                                    seed=5, n_threads=1)


@pytest.fixture
def fresh_loader(monkeypatch):
    """The loader with nothing loaded, restored afterwards."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_ERR", None)
    monkeypatch.setattr(native, "_INFO", {})
    return monkeypatch


def _recall(found: np.ndarray, truth: np.ndarray) -> float:
    return float(np.mean([len(set(f.tolist()) & set(t.tolist())) / 10
                          for f, t in zip(found, truth)]))


def test_source_is_the_reference_copy():
    with open(os.path.join(REPO, "rad_tpu", "native",
                           "hnsw_builder.cpp"), "rb") as f:
        ref = f.read()
    with open(native._SRC, "rb") as f:
        assert f.read() == ref


@pytest.mark.parametrize("n,n_bits,m,ef,seed", [
    (300, 256, 6, 32, 7), (600, 512, 8, 64, 5), (400, 1024, 16, 64, 0)])
def test_single_thread_build_edge_identical(n, n_bits, m, ef, seed):
    x = random_fingerprints(n, n_bits=n_bits, density=0.2, seed=seed + 1)
    keys = np.arange(n, dtype=np.int64) * 7 + 3
    kw = dict(keys=keys, connectivity=m, expansion_add=ef, seed=seed,
              n_threads=1)
    a = native.build_hnsw_native(x, **kw)
    _assert_same_graph(a, native.build_hnsw_native(x, **kw), "rerun")
    _assert_same_graph(ref_native.build_hnsw_native(x, **kw), a, "rad_tpu")
    kw.pop("n_threads")
    _assert_same_graph(build_hnsw(x, **kw), a, "numpy builder")
    assert a.max_level >= 1


def test_multithreaded_build_invariants(fps):
    """Four threads: levels non-increasing, rows in range with no self
    loop or duplicate, and recall@10 at ef 128 against brute force of
    at least 0.85 (the reference's bar; five such builds read 0.975 to
    0.979)."""
    g = native.build_hnsw_native(fps, connectivity=8, expansion_add=64,
                                 seed=5, n_threads=4)
    assert (np.diff(np.asarray(g.levels)) <= 0).all()
    for l, t in enumerate(g.neighbors):
        n_l = g.layer_sizes[l]
        assert t.shape == (n_l, 2 * g.connectivity if l == 0
                           else g.connectivity)
        assert ((t >= -1) & (t < n_l)).all()
        assert not (t == np.arange(n_l)[:, None]).any()
        for row in t:
            row = row[row >= 0]
            assert len(row) == len(np.unique(row)), f"dup in layer {l}"
    queries = random_fingerprints(24, n_bits=256, density=0.2, seed=88)
    _, ids = search_device(g, queries, k=10, expansion_search=128,
                           device="cpu")
    _, truth = ref_native.bruteforce_topk_native(np.asarray(g.packed),
                                                 queries, k=10)
    assert _recall(ids.numpy(), truth) >= 0.85


def test_search_equals_reference(graph):
    queries = random_fingerprints(32, n_bits=256, density=0.2, seed=9)
    d1, i1 = native.search_knn_native(graph, queries, k=10,
                                      expansion_search=128, n_threads=1)
    rd, ri = ref_native.search_knn_native(graph, queries, k=10,
                                          expansion_search=128, n_threads=1)
    np.testing.assert_array_equal(d1, rd)
    np.testing.assert_array_equal(i1, ri)
    d4, i4 = native.search_knn_native(graph, queries, k=10,
                                      expansion_search=128, n_threads=4)
    np.testing.assert_array_equal(d1, d4)
    np.testing.assert_array_equal(i1, i4)
    # a full beam sweeps the connected graph: the brute force's distances
    d_s, i_s = native.search_knn_native(graph, queries, k=10,
                                        expansion_search=len(graph),
                                        n_threads=2)
    d_b, _ = native.bruteforce_topk_native(np.asarray(graph.packed),
                                           queries, k=10)
    np.testing.assert_allclose(d_s, d_b, atol=1e-6)
    assert (np.diff(d_s, axis=1) >= 0).all()
    assert ((i_s >= 0) & (i_s < len(graph))).all()
    with pytest.raises(ValueError, match="query width"):
        native.search_knn_native(graph, queries[:, :4], n_threads=1)


def test_bruteforce_equals_reference(fps):
    queries = fps[:40]
    d, i = native.bruteforce_topk_native(fps, queries, k=7)
    rd, ri = ref_native.bruteforce_topk_native(fps, queries, k=7)
    np.testing.assert_array_equal(d, rd)
    np.testing.assert_array_equal(i, ri)
    assert (d[:, 0] == 0).all()
    d_t, _ = bruteforce_topk(torch.from_numpy(queries.view(np.int32)),
                             torch.from_numpy(fps.view(np.int32)), 7)
    np.testing.assert_allclose(d, d_t.numpy(), atol=1e-5)


@pytest.mark.parametrize("n_bits,radius", [(1024, 2), (1024, 1), (1000, 2),
                                           (1000, 1)])
def test_fingerprints_equal_reference_and_python(n_bits, radius):
    got = native.smiles_fingerprints_native(SMILES, n_bits=n_bits,
                                            radius=radius, n_threads=2)
    assert got.dtype == np.uint32 and got.shape == (len(SMILES),
                                                    (n_bits + 31) // 32)
    np.testing.assert_array_equal(got, ref_native.smiles_fingerprints_native(
        SMILES, n_bits=n_bits, radius=radius, n_threads=2))
    want = np.stack([pack.pack_fingerprints(
        pack._hash_fingerprint_bits(s, n_bits, radius)) for s in SMILES])
    np.testing.assert_array_equal(got, want)


def test_fingerprints_of_nothing():
    got = native.smiles_fingerprints_native([], n_bits=1000, n_threads=1)
    assert got.shape == (0, 32) and got.dtype == np.uint32
    np.testing.assert_array_equal(got, ref_native.smiles_fingerprints_native(
        [], n_bits=1000, n_threads=1))


def test_batch_dispatch_takes_the_native_path(monkeypatch):
    calls = []
    real = native.smiles_fingerprints_native

    def counted(smiles, **kw):
        calls.append(len(smiles))
        return real(smiles, n_threads=2, **kw)

    monkeypatch.setattr(native, "smiles_fingerprints_native", counted)
    strings = [f"C{'C' * (i % 17)}O{SMILES[i % len(SMILES)]}"
               for i in range(65)]
    batch = pack.smiles_fingerprints(strings, n_bits=512)
    one = np.stack([pack.smiles_fingerprint(s, n_bits=512)
                    for s in strings])
    np.testing.assert_array_equal(batch, one)
    np.testing.assert_array_equal(
        batch, ref_pack.smiles_fingerprints(strings, n_bits=512))
    assert calls == [65]
    pack.smiles_fingerprints(strings[:64], n_bits=512)   # 64: Python
    assert calls == [65]


def test_index_native_build_and_search_equal_reference(fps):
    keys = np.arange(500, dtype=np.int64) + 1000
    ref = rad_tpu.HNSWIndex(ndim=256, connectivity=8, expansion_add=64)
    port = HNSWIndex(ndim=256, connectivity=8, expansion_add=64,
                     device="cpu")
    for idx in (ref, port):
        idx.add(keys, fps[:500])
    _assert_same_graph(ref.build(backend="native", n_threads=1),
                       port.build(backend="native", n_threads=1), "index")
    queries = fps[500:520]
    for ef in (None, 500):
        rd, rk = ref.search(queries, k=5, expansion_search=ef,
                            backend="native")
        d, k = port.search(queries, k=5, expansion_search=ef,
                           backend="native")
        np.testing.assert_array_equal(d, rd)
        np.testing.assert_array_equal(k, rk)
    assert ((k >= 1000) & (k < 1500)).all()
    # at a full beam the native search finds the exact neighbors
    d_e, _ = port.search(queries, k=5, exact=True)
    np.testing.assert_allclose(d, d_e, atol=1e-6)


PARTITION_KW = dict(n_shards=4, connectivity=8, expansion_add=64, seed=3,
                    builder_kwargs={"n_threads": 1})


@pytest.fixture(scope="module")
def ref_partitioned(fps):
    return ref_partition.build_hnsw_partitioned(fps[:600], builder="native",
                                                **PARTITION_KW)


@pytest.mark.parametrize("builder", ["native", "auto"])
def test_partitioned_native_equals_reference(fps, ref_partitioned, builder):
    got = partition.build_hnsw_partitioned(fps[:600], builder=builder,
                                           device="cpu", **PARTITION_KW)
    _assert_same_graph(ref_partitioned, got, builder)


def test_build_index_cli_native(tmp_path, monkeypatch):
    """The index CLI with ``--backend native`` (one thread, for an exact
    comparison): the reference's native build of the reference's
    fingerprints of the same file, edge for edge."""
    from rad_tpu_torch.graph.storage import HNSWGraph
    from rad_tpu_torch.scripts import build_index

    monkeypatch.setattr(native, "build_hnsw_native", functools.partial(
        native.build_hnsw_native, n_threads=1))
    smi = tmp_path / "mols.smi"
    lines = [f"{100 + i}\tC{'C' * (i % 11)}N{SMILES[i % len(SMILES)]}"
             for i in range(120)]
    smi.write_text("\n".join(lines) + "\n")
    out = str(tmp_path / "lib")
    assert build_index.main([str(smi), "--out", out, "--ndim", "512",
                             "--connectivity", "8", "--expansion-add", "64",
                             "--backend", "native", "--device", "cpu"]) == 0
    got = HNSWGraph.load(out + ".npz")
    keys = np.array([int(l.split("\t")[0]) for l in lines], np.int64)
    x = ref_pack.smiles_fingerprints([l.split("\t")[1] for l in lines],
                                     n_bits=512)
    want = ref_native.build_hnsw_native(x, keys=keys, connectivity=8,
                                        expansion_add=64, n_threads=1)
    _assert_same_graph(want, got, "cli")
    assert os.path.exists(out + ".db")


def test_build_dir_is_honoured_and_named_by_digest(tmp_path, fresh_loader):
    fresh_loader.setenv("RAD_TPU_TORCH_BUILD_DIR", str(tmp_path))
    with open(native._SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    assert native.native_available()
    assert native._INFO["path"] == str(tmp_path /
                                       f"hnsw_builder_{digest}.so")
    assert native._INFO["isa"] in native.ISA_FLAGS
    assert os.listdir(tmp_path) == [f"hnsw_builder_{digest}.so"]
    x = random_fingerprints(50, n_bits=256, seed=2)
    d, i = native.bruteforce_topk_native(x, x[:3], k=2)
    assert (i[:, 0] == np.arange(3)).all()


def test_foreign_library_is_refused(tmp_path, fresh_loader, fps):
    fresh_loader.setenv("RAD_TPU_TORCH_BUILD_DIR", str(tmp_path))
    path = native._lib_path()
    with open(path, "wb") as f:
        f.write(b"not ours")
    uid = os.stat(path).st_uid
    fresh_loader.setattr(native.os, "getuid", lambda: uid + 1)
    assert not native.native_available()
    with pytest.raises(RuntimeError, match="not owned by this user"):
        native.build_hnsw_native(fps[:50], n_threads=1)
    idx = HNSWIndex(ndim=256, connectivity=8, device="cpu")
    idx.add(np.arange(50), fps[:50])
    with pytest.raises(RuntimeError, match="not owned by this user"):
        idx.build(backend="native")


def test_failed_compile_raises_the_compiler_message(tmp_path, fresh_loader,
                                                    fps):
    """A source g++ rejects: ``native`` by name raises with the
    compiler's message; ``"auto"`` and the batch dispatch take the host
    path; no attempt leaves a file behind."""
    bad = tmp_path / "hnsw_builder.cpp"
    bad.write_text("int f( { return 0; }\n")
    out = tmp_path / "out"
    fresh_loader.setenv("RAD_TPU_TORCH_BUILD_DIR", str(out))
    fresh_loader.setattr(native, "_SRC", str(bad))
    assert not native.native_available()
    assert "error" in native._LIB_ERR and str(bad) in native._LIB_ERR
    assert os.listdir(out) == []
    for call in (lambda: native.smiles_fingerprints_native(["C"]),
                 lambda: native.search_knn_native(None, fps[:1]),
                 lambda: native.bruteforce_topk_native(fps, fps[:1])):
        with pytest.raises(RuntimeError, match="error"):
            call()
    idx = HNSWIndex(ndim=256, connectivity=8, device="cpu")
    idx.add(np.arange(60), fps[:60])
    with pytest.raises(RuntimeError, match="error"):
        idx.build(backend="native")
    with pytest.raises(RuntimeError, match="error"):
        partition.build_hnsw_partitioned(fps[:60], builder="native",
                                         connectivity=8, device="cpu")
    assert partition._resolve_builder("auto", "cpu") is build_hnsw
    strings = [f"C{'O' * (i % 5)}N" for i in range(70)]
    np.testing.assert_array_equal(
        pack.smiles_fingerprints(strings, n_bits=256),
        np.stack([pack.smiles_fingerprint(s, n_bits=256) for s in strings]))
