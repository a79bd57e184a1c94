"""rad_tpu_torch's scalar-loop probes against the TPU probes and a serial
model.

The reference kernels are closures inside ``main()`` of
``benchmarks/bench_scalar_probe.py``, which prints only timings. The test
runs that ``main`` in interpret mode with ``pallas_call`` wrapped so that
every kernel's concrete outputs are recorded, rebuilds the same inputs
from ``default_rng(0)`` and holds the port's plain twins (what the
wrappers run on the CPU) to them. A second oracle, independent of both
packages, is a numpy model of the three serial loops.

Tolerances. Counts, the gather sum and ``emit[:n_new]`` are exact. The
score sum ``ssum`` is a float64 sum rounded once in the port and an f32
sum in candidate order in the reference and the model: every f32
summation order of k terms in [0, 1) lies within ``k * 2**-24 * ssum`` of
the exact sum, which is the bound used. ``emit[n_new:]`` is undefined in
the reference (it reads the output before writing it); the port pads it
with -1. The ``gpu`` tests hold the CUDA kernels to the twins on the card
(``ssum`` within one f32 ulp: both round a float64 sum once).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.experimental.pallas

from benchmarks import bench_scalar_probe as ref_probe
from rad_tpu_torch import bench_scalar_probe as probe
from rad_tpu_torch.traverse import candidate_ops as ops


def _inputs(k, n):
    """numpy copies of the benchmark's inputs (the reference's draws)."""
    return {name: t.numpy() for name, t in
            probe.probe_inputs(k, n, "cpu").items()}


def _serial_model(idx, tab, bm, scored, scores):
    """The three TPU loops, one candidate at a time."""
    n = scores.shape[0]
    idx = idx.reshape(-1)
    gather = np.int32(0)
    with np.errstate(over="ignore"):
        for j in idx:
            gather = np.int32(gather + tab[j, 0])
    bits = bm.reshape(-1).astype(np.uint32).copy()
    checkset = 0
    for j in idx:
        w, b = divmod(int(j), 32)
        checkset += 1 - ((int(bits[w]) >> b) & 1)
        bits[w] |= np.uint32(1 << b)
    bits = bm.reshape(-1).astype(np.uint32).copy()
    sbits = scored.reshape(-1).astype(np.uint32)
    emit, ssum = [], np.float32(0)
    for j in idx:
        w, b = divmod(int(j), 32)
        if not (int(sbits[w]) >> b) & 1:
            emit.append(int(j))
        if not (int(bits[w]) >> b) & 1:
            ssum = np.float32(ssum + scores[j, 0])
        bits[w] |= np.uint32(1 << b)
    assert n == 32 * bits.shape[0]
    return dict(gather=int(gather), checkset=checkset, n_new=len(emit),
                emit=np.asarray(emit, np.int32), ssum=float(ssum))


def _run_twins(x):
    t = {name: torch.from_numpy(a) for name, a in x.items()}
    before = (ops.scalar_gather.launches, ops.scalar_checkset.launches,
              ops.scalar_chain.launches)
    gather = ops.scalar_gather(t["idx"], t["tab"])
    checkset = ops.scalar_checkset(t["idx"], t["bm"])
    out, emit, n_new, ssum = ops.scalar_chain(t["idx"], t["scored"],
                                              t["bm"], t["scores"])
    assert before == (ops.scalar_gather.launches,
                      ops.scalar_checkset.launches,
                      ops.scalar_chain.launches)  # twins: no launch
    assert gather.shape == checkset.shape == out.shape == (1, 1)
    assert emit.shape == t["idx"].shape and emit.dtype == torch.int32
    return dict(gather=int(gather), checkset=int(checkset),
                n_new=int(n_new), emit=emit.numpy().reshape(-1),
                ssum=float(ssum), out=float(out))


def _assert_matches(got, want, k):
    assert got["gather"] == want["gather"]
    assert got["checkset"] == want["checkset"]
    assert got["n_new"] == want["n_new"]
    np.testing.assert_array_equal(got["emit"][:got["n_new"]], want["emit"])
    assert (got["emit"][got["n_new"]:] == -1).all()
    tol = k * 2.0 ** -24 * max(want["ssum"], 1.0)
    assert abs(got["ssum"] - want["ssum"]) <= tol
    assert abs(got["out"] - (want["ssum"] + want["n_new"])) <= 2 * tol


def _case(name, k, n):
    x = _inputs(k, n)
    if name == "duplicates":
        # every id four times over, shuffled: a duplicate counts once
        x["idx"] = np.random.default_rng(1).permutation(
            np.tile(x["idx"][: k // 4], (4, 1)))
    elif name == "all_set":
        x["bm"][:] = -1
        x["scored"][:] = -1
    elif name == "all_clear":
        x["bm"][:] = 0
        x["scored"][:] = 0
    elif name == "sign_bit":
        # only ids on bit 31 of their word, whose words have that bit set
        x["idx"] = (x["idx"] // 32) * 32 + 31
        x["bm"][::2] |= np.int32(-2 ** 31)
        x["scored"][1::2] |= np.int32(-2 ** 31)
    return x


@pytest.fixture(scope="module")
def tpu_probe_outputs():
    """Outputs of the reference's three Pallas kernels (interpret mode) on
    its own inputs at k = 64, n = 1024, recorded through a wrapped
    ``pallas_call`` while its ``main`` runs."""
    recorded = {}
    orig = jax.experimental.pallas.pallas_call

    def recording_pallas_call(kernel, *args, **kwargs):
        call = orig(kernel, *args, **kwargs)

        def run(*operands):
            out = call(*operands)
            recorded[kernel.__name__] = jax.tree_util.tree_map(np.asarray,
                                                               out)
            return out

        return run

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental.pallas, "pallas_call", recording_pallas_call)
    try:
        with jax.disable_jit():
            rc = ref_probe.main(["--interpret", "--k", "64", "--n", "1024",
                                 "--reps", "1", "--chain-steps", "1"])
    finally:
        mp.undo()
    assert rc == 0 and sorted(recorded) == [
        "chain_kernel", "checkset_kernel", "gather_kernel"]
    return recorded


def test_twins_match_interpret_mode_tpu_probes(tpu_probe_outputs):
    k, n = 64, 1024
    got = _run_twins(_inputs(k, n))
    ref = tpu_probe_outputs
    assert got["gather"] == int(ref["gather_kernel"][0, 0])
    assert got["checkset"] == int(ref["checkset_kernel"][0, 0])
    ref_out, ref_emit = ref["chain_kernel"]
    np.testing.assert_array_equal(got["emit"][:got["n_new"]],
                                  ref_emit.reshape(-1)[:got["n_new"]])
    # the reference returns ssum + n_new only; n_new is pinned by the
    # serial model below and by the emitted prefix above
    tol = 2 * k * 2.0 ** -24 * float(ref_out[0, 0])
    assert abs(got["out"] - float(ref_out[0, 0])) <= tol
    assert abs(got["ssum"] + got["n_new"] - float(ref_out[0, 0])) <= tol


def test_serial_model_matches_interpret_mode_tpu_probes(tpu_probe_outputs):
    """The numpy model is the reference's loops: it reproduces the Pallas
    outputs exactly (same f32 additions in the same order)."""
    x = _inputs(64, 1024)
    want = _serial_model(**x)
    ref = tpu_probe_outputs
    assert want["gather"] == int(ref["gather_kernel"][0, 0])
    assert want["checkset"] == int(ref["checkset_kernel"][0, 0])
    ref_out, ref_emit = ref["chain_kernel"]
    assert np.float32(np.float32(want["ssum"]) + np.float32(want["n_new"])) \
        == ref_out[0, 0]
    np.testing.assert_array_equal(want["emit"],
                                  ref_emit.reshape(-1)[:want["n_new"]])


@pytest.mark.parametrize("k,n", [(64, 1024), (1500, 4096), (1, 32)])
@pytest.mark.parametrize("name", ["defaults", "duplicates", "all_set",
                                  "all_clear", "sign_bit"])
def test_twins_match_serial_model(name, k, n):
    """k = 1500 is not a multiple of the kernels' 1024-thread block."""
    x = _case(name, k, n)
    got = _run_twins(x)
    _assert_matches(got, _serial_model(**x), k)
    if name == "all_set":
        assert got["checkset"] == got["n_new"] == 0 and got["ssum"] == 0
    if name == "all_clear":
        assert got["n_new"] == k
        assert got["checkset"] == len(np.unique(x["idx"]))


def test_gather_sum_wraps_as_int32():
    idx = torch.arange(4, dtype=torch.int32).reshape(4, 1)
    tab = torch.full((32, 1), 2 ** 30, dtype=torch.int32)
    assert int(ops.scalar_gather(idx, tab)) == 0
    assert int(ops.scalar_gather(idx[:3], tab)) == -2 ** 30


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = {name: torch.from_numpy(a) for name, a in _inputs(8, 64).items()}
    with pytest.raises(ValueError, match="idx"):
        ops.scalar_gather(x["idx"].long(), x["tab"])
    with pytest.raises(ValueError, match="scored"):
        ops.scalar_chain(x["idx"], x["scored"][:1], x["bm"], x["scores"])
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.scalar_chain(x["idx"], x["scored"], x["bm"], x["scores"][:40])
    with pytest.raises(ValueError, match="contiguous"):
        ops.scalar_checkset(x["idx"].repeat(2, 1)[::2], x["bm"])


def test_entry_point_exits_nonzero_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert probe.main(["--k", "64", "--n", "1024"]) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err


def test_probe_inputs_are_the_reference_draws():
    """Same generator, same order of draws as the reference's main()."""
    k, n = 64, 1024
    x = _inputs(k, n)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(x["idx"], rng.integers(0, n, size=(k, 1)))
    np.testing.assert_array_equal(x["tab"],
                                  rng.integers(0, 100, size=(n, 1)))
    np.testing.assert_array_equal(
        x["bm"], rng.integers(0, 2**31, size=(n // 32, 1)))
    np.testing.assert_array_equal(
        x["scored"], rng.integers(0, 2**31, size=(n // 32, 1)))
    np.testing.assert_array_equal(
        x["scores"], rng.random((n, 1)).astype(np.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _on(x, device):
    return {name: torch.from_numpy(a).to(device) for name, a in x.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(8192, 1 << 20), (1500, 4096), (1, 32),
                                 (8192, 1 << 22)])
@pytest.mark.parametrize("name", ["defaults", "duplicates", "all_set",
                                  "all_clear", "sign_bit"])
def test_cuda_probes_equal_twins(cuda, name, k, n):
    """n = 2^22: a 512 KB bitmap, past a block's shared memory, so the
    kernels work on the global scratch copy."""
    t = _on(_case(name, k, n), cuda)
    before = (ops.scalar_gather.launches, ops.scalar_checkset.launches,
              ops.scalar_chain.launches)
    gather = ops.scalar_gather(t["idx"], t["tab"])
    checkset = ops.scalar_checkset(t["idx"], t["bm"])
    bm_before = t["bm"].clone()
    out, emit, n_new, ssum = ops.scalar_chain(t["idx"], t["scored"],
                                              t["bm"], t["scores"])
    torch.cuda.synchronize()
    assert (ops.scalar_gather.launches, ops.scalar_checkset.launches,
            ops.scalar_chain.launches) == tuple(b + 1 for b in before)
    assert torch.equal(t["bm"], bm_before)  # bits are set in a copy
    assert torch.equal(gather, ops.scalar_gather_plain(t["idx"], t["tab"]))
    assert torch.equal(checkset,
                       ops.scalar_checkset_plain(t["idx"], t["bm"]))
    w_out, w_emit, w_n_new, w_ssum = ops.scalar_chain_plain(
        t["idx"], t["scored"], t["bm"], t["scores"])
    assert int(n_new) == int(w_n_new)
    assert torch.equal(emit, w_emit)
    ulp = 2.0 ** -23 * max(float(w_ssum), 1.0)
    assert abs(float(ssum) - float(w_ssum)) <= ulp
    assert abs(float(out) - float(w_out)) <= 2 * ulp


@pytest.mark.gpu
def test_entry_point_prints_the_metric_line(cuda, capsys):
    before = ops.scalar_chain.launches
    assert probe.main(["--k", "8192", "--n", str(1 << 20), "--reps", "3",
                       "--chain-steps", "4"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "scalar_loop_probe"
    assert {"gather_ns", "checkset_ns", "chain_ns", "k", "n",
            "breakeven_ns"} <= set(line)
    assert all(line[key] > 0 for key in ("gather_ns", "checkset_ns",
                                         "chain_ns", "breakeven_ns"))
    assert ops.scalar_chain.launches == before + 4 * (1 + 3)
