"""rad_tpu_torch.bench's matmul path against the repo's bench.py, and the
port's benchmark entry points without a card.

``matmul_min_dist`` must give minima array-equal to ``bench.py``'s
``_xla_min_dist`` (the same f32 op order over exact intersections); the
kernel path's minima are ``tanimoto_nn``'s (tests/test_torch_nn.py).
Both entry points refuse to measure without a CUDA device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as ref_bench
from rad_tpu.fp import random_fingerprints
from rad_tpu_torch import bench, bench_kernel_variants, bench_prefix
from rad_tpu_torch.fp import kernels
from rad_tpu_torch.fp.pack import to_torch_packed


@pytest.mark.parametrize("n_bits,block", [(256, 256), (1024, 512)])
def test_matmul_path_array_equal_to_bench(n_bits, block):
    db = random_fingerprints(1024, n_bits=n_bits, density=0.1, seed=0)
    q = db[:512].copy()
    q[5] = random_fingerprints(1, n_bits=n_bits, density=0.3, seed=9)[0]
    ref = np.asarray(ref_bench._xla_min_dist(jax, jnp, block)(
        jnp.asarray(db), jnp.asarray(q)))
    tdb, tq = to_torch_packed(db, "cpu"), to_torch_packed(q, "cpu")
    got = bench.matmul_min_dist(tdb, tq, block)
    assert got.dtype == torch.float32 and got.shape == (512,)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the exact 1-NN gives the same minima on a library without empty rows
    np.testing.assert_array_equal(kernels.tanimoto_nn(tq, tdb)[0].numpy(),
                                  ref)


def test_unpack_to_dtype_matches_reference():
    from rad_tpu.fp.tanimoto import unpack_to_dtype
    p = random_fingerprints(7, n_bits=96, density=0.4, seed=3)
    ref = np.asarray(unpack_to_dtype(jnp.asarray(p), jnp.float32))
    got = bench.unpack_to_dtype(to_torch_packed(p, "cpu"), torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("module", [bench, bench_kernel_variants,
                                    bench_prefix])
def test_entry_points_need_a_card(module, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert module.main(["--n", "4096", "--q", "64"]) != 0
    out, err = capsys.readouterr()
    assert "no CUDA device" in err and "{" not in out


def test_mma_rate_needs_nvcc(monkeypatch, tmp_path):
    """The rate probe is compiled where it runs: with no ``nvcc`` it raises
    and measures nothing."""
    from rad_tpu_torch import _cuda, bench_mma_rate
    assert bench_mma_rate._SOURCE.exists()
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("RAD_TPU_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        bench_mma_rate.main()
    assert _cuda.NVCC_FLAGS[:2] == ["-gencode", "arch=compute_90a,code=sm_90a"]


@pytest.mark.gpu
def test_cuda_matmul_path_equals_exact_nn():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    db = to_torch_packed(random_fingerprints(1 << 15, 1024, 0.1, seed=0), dev)
    q = db[:512]
    got = bench.matmul_min_dist(db, q, 1 << 13)
    assert torch.equal(got, kernels.tanimoto_nn(q, db)[0])
    assert torch.equal(got, bench.matmul_min_dist(db.cpu(), q.cpu(),
                                                  1 << 13).to(dev))


def test_bench_prefix_on_the_cpu(capsys, monkeypatch):
    """The prefix sweep on a small library when the CPU is asked for: the
    reference's JSON line, one result a config, the unscreened search's
    recall high on a graph from the native builder, the reference's."""
    import json

    from rad_tpu_torch import native

    built = []
    real = native.build_hnsw_native

    def recorded(fps, **kw):
        built.append(len(fps))
        return real(fps, **kw)

    monkeypatch.setattr(native, "build_hnsw_native", recorded)
    assert bench_prefix.main(["--n", "1500", "--q", "32", "--n-bits", "256",
                              "--connectivity", "8", "--configs",
                              "0:0,128:16,64:64", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert line["metric"] == "prefix_filter_sweep"
    assert (line["n"], line["ef"]) == (1500, 64)
    assert [(r["prefix_bits"], r["keep"]) for r in line["results"]] == [
        (0, 0), (128, 16), (64, 64)]
    assert line["results"][0]["recall"] >= 0.9
    assert all(r["qps"] > 0 for r in line["results"])
    assert built == [1500]
