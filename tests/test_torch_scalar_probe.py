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
(``ssum`` within one f32 ulp: both round a float64 sum once; the gather
sum array-equal), on one CTA and on a cluster of eight, and check that a
call allocates nothing sized by the library.
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
    """The three TPU loops, one candidate at a time (ids outside [0, n)
    skipped, as the port's contract says)."""
    n = scores.shape[0]
    idx = idx.reshape(-1)
    idx = idx[(idx >= 0) & (idx < n)]
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
    elif name == "one id":      # one id repeated k times
        x["idx"][:] = x["idx"][0]
    elif name == "last id":     # every id n - 1
        x["idx"][:] = n - 1
    elif name == "out of range":
        # a quarter of the ids -5, n or 2^31 - 1: skipped
        far = np.random.default_rng(2).random(k) < 0.25
        x["idx"][far, 0] = np.array([-5, n, 2 ** 31 - 1], np.int32)[
            np.arange(int(far.sum())) % 3]
    return x


KINDS = ["defaults", "duplicates", "all_set", "all_clear", "sign_bit",
         "one id", "last id", "out of range"]


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


def _tpu_gather(x):
    """The reference's ``gather`` kernel in interpret mode on the inputs
    ``x`` (k, n from their shapes): its ``main`` runs with ``pallas_call``
    wrapped so that every kernel it builds is captured and none runs
    (``main`` reports each unlowerable and goes on); the captured gather,
    whose loop bound is ``k``, then runs here on ``x``."""
    k, n = x["idx"].shape[0], x["tab"].shape[0]
    built = {}
    orig = jax.experimental.pallas.pallas_call

    def capture(kernel, *args, **kwargs):
        built[kernel.__name__] = orig(kernel, *args, **kwargs)

        def refuse(*operands):
            raise RuntimeError("captured, not run")

        return refuse

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental.pallas, "pallas_call", capture)
    try:
        rc = ref_probe.main(["--interpret", "--k", str(k), "--n", str(n),
                             "--reps", "1", "--chain-steps", "1"])
    finally:
        mp.undo()
    assert rc == 0
    out = built["gather_kernel"](jax.numpy.asarray(x["idx"]),
                                 jax.numpy.asarray(x["tab"]))
    return int(np.asarray(out)[0, 0])


@pytest.mark.parametrize("k", [1, 4097, 8193])
def test_gather_twin_matches_tpu_gather_off_round_sizes(k):
    """k off the kernels' rounds (4,096 candidates a CTA) and clusters: the
    twin, the interpret-mode Pallas ``gather`` and the serial model give the
    same int32."""
    n = 1 << 13
    x = _inputs(k, n)
    got = int(ops.scalar_gather(torch.from_numpy(x["idx"]),
                                torch.from_numpy(x["tab"])))
    assert got == _tpu_gather(x) == _serial_model(**x)["gather"]


@pytest.mark.parametrize("k,cluster", [(0, 1), (1, 1),
                                       (ops._CLUSTER_MIN_K - 1, 1),
                                       (ops._CLUSTER_MIN_K, 8), (65537, 8)])
def test_probe_cluster_by_k(k, cluster):
    """Every probe's launch, ``gather``'s too: one CTA below 2,048
    candidates, a cluster of eight from 2,048; the set's CTAs agree."""
    assert ops._CLUSTER_MIN_K == 2048
    assert ops._probe_cluster(k) == cluster == ops._probe_set(k)[0]
    assert ops._probe_cluster(k, 1) == 1 and ops._probe_cluster(k, 8) == 8
    with pytest.raises(ValueError, match="cluster"):
        ops._probe_cluster(k, 2)


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
@pytest.mark.parametrize("name", KINDS)
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
    if name in ("one id", "last id"):
        assert got["checkset"] <= 1


@pytest.mark.parametrize("k,cluster,log2,shared", [
    (0, 1, 5, True), (1, 1, 5, True), (ops._CLUSTER_MIN_K - 1, 1, None, True),
    (ops._CLUSTER_MIN_K, 8, None, True), (8192, 8, 15, True),
    (65536, 8, 18, True), (65537, 8, 19, False)])
def test_probe_set_size_place_and_cluster(k, cluster, log2, shared):
    """At least 4k slots of 4 bytes in a power of two and 32 a CTA; one CTA
    below ``_CLUSTER_MIN_K`` candidates, 8 from it; the set in the
    cluster's shared memory up to k = 65,536 (128 KB a CTA), in a global
    buffer from one candidate more."""
    got = ops._probe_set(k)
    assert got[0] == cluster and got[2] == shared
    if log2 is not None:
        assert got[1] == log2
    assert (1 << got[1]) >= 4 * k and (1 << got[1]) // cluster >= 32
    assert (1 << got[1]) <= max(8 * k, 32 * cluster)


@pytest.mark.parametrize("k,cluster,log2,shared", [
    (1, 1, 5, True), (8192, 1, 15, True), (8193, 1, 16, False),
    (1, 8, 8, True), (32768, 8, 17, True)])
def test_probe_set_for_a_chosen_cluster(k, cluster, log2, shared):
    """One CTA holds the set up to k = 8,192; a cluster of 8 from 1."""
    assert ops._probe_set(k, cluster) == (cluster, log2, shared)


def test_probe_set_refuses_other_clusters():
    with pytest.raises(ValueError, match="cluster"):
        ops._probe_set(64, 4)


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


def _twins(t):
    """The plain twins' ``(checkset, (out, emit, n_new, ssum))``."""
    return (ops.scalar_checkset_plain(t["idx"], t["bm"]),
            ops.scalar_chain_plain(t["idx"], t["scored"], t["bm"],
                                   t["scores"]))


def _assert_probes_equal(checkset, chain, want):
    w_checkset, (w_out, w_emit, w_n_new, w_ssum) = want
    out, emit, n_new, ssum = chain
    assert torch.equal(checkset, w_checkset)
    assert int(n_new) == int(w_n_new)
    assert torch.equal(emit, w_emit)
    ulp = 2.0 ** -23 * max(float(w_ssum), 1.0)
    assert abs(float(ssum) - float(w_ssum)) <= ulp
    assert abs(float(out) - float(w_out)) <= 2 * ulp


@pytest.mark.gpu
@pytest.mark.parametrize("n", [32, 1 << 20, 1 << 22, 1 << 24])
@pytest.mark.parametrize("k", [1, 1023, 1025, 8192, 8193, 32768, 32769])
@pytest.mark.parametrize("name", KINDS)
def test_cuda_probes_equal_twins(cuda, name, k, n):
    """Every kind at k across the kernels' 8-candidate threads, a CTA's
    4,096-candidate rounds and the cluster's 32,768, n up to 2^24 (a 2 MB
    bitmap, read in place): the wrappers' own choice of cluster and both
    instances (1 and 8 CTAs), each twice in a row, the bitmaps unmodified."""
    t = _on(_case(name, k, n), cuda)
    before = (ops.scalar_gather.launches, ops.scalar_checkset.launches,
              ops.scalar_chain.launches)
    gather = ops.scalar_gather(t["idx"], t["tab"])
    assert torch.equal(gather, ops.scalar_gather_plain(t["idx"], t["tab"]))
    inputs = {name: t[name].clone() for name in ("bm", "scored", "scores")}
    want = _twins(t)
    for cluster in (None, 1, 8):
        for _ in range(2):   # two calls in a row: no state between them
            if cluster is None:
                checkset = ops.scalar_checkset(t["idx"], t["bm"])
                chain = ops.scalar_chain(t["idx"], t["scored"], t["bm"],
                                         t["scores"])
            else:
                checkset = ops._checkset_cuda(t["idx"], t["bm"], cluster)
                chain = ops._chain_cuda(t["idx"], t["scored"], t["bm"],
                                        t["scores"], cluster)
            torch.cuda.synchronize()
            _assert_probes_equal(checkset, chain, want)
    assert (ops.scalar_gather.launches, ops.scalar_checkset.launches,
            ops.scalar_chain.launches) == (before[0] + 1, before[1] + 6,
                                           before[2] + 6)
    for name, a in inputs.items():
        assert torch.equal(t[name], a), name  # the bitmaps are only read


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8192, 262144])
def test_cuda_probes_allocate_nothing_sized_by_n(cuda, k):
    """At n = 2^24 a call's device memory grows by its outputs and, past
    the cluster's shared memory (k = 262,144), the per-call set: no copy
    of a 2 MB bitmap."""
    t = _on(_inputs(k, 1 << 24), cuda)
    cluster, log2, shared = ops._probe_set(k)
    table = 0 if shared else 4 << log2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    checkset = ops.scalar_checkset(t["idx"], t["bm"])
    chain = ops.scalar_chain(t["idx"], t["scored"], t["bm"], t["scores"])
    torch.cuda.synchronize()
    outputs = 4 + 8 + 4 + 4 * k   # checkset's count; chain's sums, n_new, emit
    slack = 4 * 512               # the allocator's rounding, per block
    assert torch.cuda.memory_allocated(cuda) - base <= outputs + slack
    assert torch.cuda.max_memory_allocated(cuda) - base <= \
        outputs + table + slack + 512
    _assert_probes_equal(checkset, chain, _twins(t))


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


def _gather_case(kind, k, n):
    """The benchmark's inputs at ``k``, ``n`` changed as ``kind`` says;
    "wrapping" draws the table over all of int32, so the sum wraps."""
    if kind == "wrapping":
        x = _inputs(k, n)
        x["tab"] = np.random.default_rng(k).integers(
            -2 ** 31, 2 ** 31, size=(n, 1), dtype=np.int32)
        return x
    return _case(kind, k, n)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [32, 1 << 20])
@pytest.mark.parametrize("k", [1, 2047, 2048, 8193, 32769, 65537])
@pytest.mark.parametrize("kind", ["defaults", "one id", "last id",
                                  "out of range", "wrapping"])
def test_cuda_gather_equals_twin_on_both_instances(cuda, kind, k, n):
    """``gather`` by the wrapper's choice and on 1 and 8 CTAs, twice each,
    array-equal to its twin: k on both sides of the cluster's threshold and
    of a cluster round (32,768 candidates), ids out of range skipped, sums
    that wrap; a call allocates its one output and nothing sized by n."""
    t = _on(_gather_case(kind, k, n), cuda)
    want = ops.scalar_gather_plain(t["idx"], t["tab"])
    before = ops.scalar_gather.launches
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    got = ops.scalar_gather(t["idx"], t["tab"])
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(cuda) - base <= 512
    assert torch.equal(got, want)
    for cluster in (1, 8, 8, 1):
        got = ops._gather_cuda(t["idx"], t["tab"], cluster)
        torch.cuda.synchronize()
        assert torch.equal(got, want), cluster
    assert ops.scalar_gather.launches == before + 5
