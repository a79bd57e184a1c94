"""rad_tpu_torch's fused candidate kernels (K1/K2) against rad_tpu's.

On the CPU the wrappers run their plain twins, which must be array-equal
to ``candidate_filter_pallas`` / ``integrate_candidates_pallas`` in
interpret mode: the ids and masks are integers and the scores are copied
or gathered, so the tolerance is exact. The cases are those of
``tests/test_pallas_ops.py`` plus duplicates inside ``to_score`` (the
serial kernel marks only the first occurrence fresh), a ``to_score``
narrower than the candidates (``fused_run``'s ``narrow_width``), and the
edge shapes of the CUDA kernels' dedup table (:func:`edge_case`: K off and
across the kernels' 1,024-thread rounds, one id repeated, every candidate
invalid in phase B only, ids ``n - 1``). Ids past ``n`` and rows past
``r_rows``, and an empty ``to_score``, which the reference kernels never
see, are held to a serial numpy model of their loops. The ``gpu`` tests hold each
CUDA kernel to its twin on the card, up to 32,768 candidates (the dedup
table in shared memory and in a global buffer), and check that a call
allocates nothing sized by the library.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rad_tpu.traverse.pallas_ops import (candidate_filter_pallas,
                                         integrate_candidates_pallas)
from rad_tpu_torch.traverse import candidate_ops as ops

NAMES = ["scored", "scores", "enqueued", "fresh", "push", "cand_score"]


def make_case(rng, n=512, k=256, n_rows=700, scored_frac=0.5):
    """The recipe of tests/test_pallas_ops.py: -1s and forced duplicates."""
    cand = rng.integers(-1, n, size=k).astype(np.int32)
    cand[rng.random(k) < 0.2] = -1
    cand[k // 2:] = np.where(rng.random(k - k // 2) < 0.5,
                             cand[: k - k // 2], cand[k // 2:])
    scored = rng.random(n) < scored_frac
    scores = np.where(scored, rng.random(n), np.inf).astype(np.float32)
    enqueued = rng.random(n_rows) < 0.4
    row = np.minimum(np.maximum(cand, 0) + rng.integers(0, 3, size=k),
                     n_rows - 1).astype(np.int32)
    return cand, scored, scores, enqueued, row


EDGE_KINDS = ("one id", "last id", "phase B invalid")


def edge_case(kind: str, k: int, seed: int = 13):
    """``(to_score, new_scores, cand, row, scored, scores, enqueued)`` of
    one edge case at ``k`` candidates (numpy; ``to_score`` is the serial
    filter's output unless the kind says otherwise). Ids stay in ``[-1,
    n)`` and rows in ``[0, r_rows)`` except for ``"out of range"``."""
    rng = np.random.default_rng(seed + k)
    n = max(2 * k, 64)
    n_rows = n + n // 16 + 1
    cand, scored, scores, enqueued, row = make_case(rng, n=n, k=k,
                                                    n_rows=n_rows)
    if kind == "one id":        # every candidate the same unscored id
        j = int(np.flatnonzero(~scored)[0])
        cand[:], row[:] = j, j
        enqueued[j] = False
    elif kind == "last id":     # ids n - 1 and rows r_rows - 1, unmarked
        last = rng.random(k) < 0.3
        cand[last], row[last] = n - 1, n_rows - 1
        scored[n - 1], enqueued[n_rows - 1] = False, False
    elif kind == "out of range":
        far = rng.random(k)
        cand[far < 0.15] = rng.integers(n, 3 * n, size=int((far < 0.15).sum()))
        cand[(far >= 0.15) & (far < 0.2)] = -7
        far = rng.random(k)
        row[far < 0.15] = rng.integers(n_rows, 3 * n_rows,
                                       size=int((far < 0.15).sum()))
        row[(far >= 0.15) & (far < 0.2)] = -3
    to_score = serial_filter(cand, scored)
    if kind == "one id":
        to_score = cand.copy()   # a duplicate inside to_score, k times
    elif kind == "kt 0":
        to_score = to_score[:0]
    elif kind == "phase B invalid":
        cand[:] = -1
    new_scores = rng.random(len(to_score)).astype(np.float32)
    return to_score, new_scores, cand, row, scored, scores, enqueued


def serial_filter(cand, scored):
    """K1's loop, one candidate at a time (ids outside [0, n) invalid)."""
    mark, out, pos = scored.copy(), np.full(len(cand), -1, np.int32), 0
    for j in cand:
        if 0 <= j < len(mark) and not mark[j]:
            mark[j], out[pos], pos = True, j, pos + 1
    return out


def serial_integrate(to_score, new_scores, cand, row, scored, scores,
                     enqueued):
    """K2's two loops, one candidate at a time (ids outside [0, n) and
    rows outside [0, r_rows) invalid), on copies of the tables."""
    scored, scores, enqueued = scored.copy(), scores.copy(), enqueued.copy()
    fresh = np.zeros(len(to_score), bool)
    for i, j in enumerate(to_score):
        if 0 <= j < len(scored) and not scored[j]:
            scored[j], scores[j], fresh[i] = True, new_scores[i], True
    push = np.zeros(len(cand), bool)
    cand_score = np.full(len(cand), np.inf, np.float32)
    for i, (j, r) in enumerate(zip(cand, row)):
        if 0 <= j < len(scored) and 0 <= r < len(enqueued) \
                and not enqueued[r]:
            enqueued[r], push[i], cand_score[i] = True, True, scores[j]
    return [scored, scores, enqueued, fresh, push, cand_score]


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


def _integrate_both(to_score, new_scores, cand, row, scored, scores,
                    enqueued):
    """(port outputs, reference outputs) as numpy, same inputs."""
    want = integrate_candidates_pallas(
        jnp.asarray(to_score), jnp.asarray(new_scores), jnp.asarray(cand),
        jnp.asarray(row), jnp.asarray(scored), jnp.asarray(scores),
        jnp.asarray(enqueued), interpret=True)
    got = ops.integrate_candidates(
        _t(to_score), _t(new_scores), _t(cand), _t(row), _t(scored),
        _t(scores), _t(enqueued))
    return ([g.numpy() for g in got], [np.asarray(w) for w in want])


def _assert_outputs_equal(got, want):
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_candidate_filter_matches_pallas(seed):
    cand, scored, *_ = make_case(np.random.default_rng(seed))
    want = candidate_filter_pallas(jnp.asarray(cand), jnp.asarray(scored),
                                   interpret=True)
    scored_t = _t(scored)
    got = ops.candidate_filter(_t(cand), scored_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(scored_t.numpy(), scored)  # untouched


@pytest.mark.parametrize("kind,k", [("random", 1), ("random", 1023),
                                    ("random", 1025), ("random", 4097),
                                    ("one id", 1500), ("last id", 1500)])
def test_candidate_filter_edge_shapes_match_pallas(kind, k):
    _, _, cand, _, scored, _, _ = edge_case(kind, k)
    want = np.asarray(candidate_filter_pallas(jnp.asarray(cand),
                                              jnp.asarray(scored),
                                              interpret=True))
    np.testing.assert_array_equal(ops.candidate_filter(_t(cand),
                                                       _t(scored)).numpy(),
                                  want)
    np.testing.assert_array_equal(serial_filter(cand, scored), want)


def test_candidate_filter_out_of_range_ids_match_serial_loop():
    _, _, cand, _, scored, _, _ = edge_case("out of range", 3000)
    got = ops.candidate_filter(_t(cand), _t(scored)).numpy()
    np.testing.assert_array_equal(got, serial_filter(cand, scored))


@pytest.mark.parametrize("k,log2,shared", [(1, 1, True), (2048, 12, True),
                                           (8192, 14, True),
                                           (8193, 15, False)])
def test_dedup_table_size_and_place(k, log2, shared):
    """At least 2k slots of 8 bytes in a power of two, in shared memory up
    to k = 8,192 (128 KB), in a global buffer from one candidate more."""
    assert ops._dedup_table(k) == (log2, shared)
    assert (1 << log2) >= 2 * k and (8 << log2) <= 2 * 8 * 2 * k


def test_candidate_filter_all_invalid():
    got = ops.candidate_filter(torch.full((64,), -1, dtype=torch.int32),
                               torch.zeros(128, dtype=torch.bool))
    assert bool((got == -1).all())


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_integrate_matches_pallas(seed):
    rng = np.random.default_rng(seed)
    cand, scored, scores, enqueued, row = make_case(rng)
    to_score = np.asarray(candidate_filter_pallas(
        jnp.asarray(cand), jnp.asarray(scored), interpret=True))
    new_scores = rng.random(to_score.shape[0]).astype(np.float32)
    _assert_outputs_equal(*_integrate_both(to_score, new_scores, cand, row,
                                           scored, scores, enqueued))


@pytest.mark.parametrize("kind,k", [("random", 1), ("random", 1023),
                                    ("random", 1025), ("random", 4097),
                                    *[(kind, 1500) for kind in EDGE_KINDS]])
def test_integrate_edge_shapes_match_pallas(kind, k):
    case = edge_case(kind, k)
    _assert_outputs_equal(*_integrate_both(*case))
    _assert_outputs_equal(serial_integrate(*case),
                          _integrate_both(*case)[1])


@pytest.mark.parametrize("kind", ["out of range", "kt 0"])
def test_integrate_matches_serial_loop(kind):
    """Inputs the reference kernel cannot take: ids past n and rows past
    r_rows, and an empty to_score (its loop's ref has no row)."""
    case = edge_case(kind, 3000)
    got = ops.integrate_candidates(*[_t(a) for a in case])
    _assert_outputs_equal([g.numpy() for g in got], serial_integrate(*case))


def test_integrate_pipelined_duplicate_noop():
    """An id already scored (pipelined double delivery) is not fresh and
    keeps its score."""
    n, k = 64, 8
    scored = np.zeros(n, bool)
    scored[5] = True
    scores = np.full(n, np.inf, np.float32)
    scores[5] = 0.25
    ts = np.array([5, 7, -1, -1, -1, -1, -1, -1], np.int32)
    got, want = _integrate_both(ts, np.full(k, 0.9, np.float32),
                                np.full(k, -1, np.int32),
                                np.zeros(k, np.int32), scored, scores,
                                np.zeros(96, bool))
    _assert_outputs_equal(got, want)
    s_o, sc_o, _, fresh, _, _ = got
    assert not fresh[0] and fresh[1]
    assert sc_o[5] == np.float32(0.25) and sc_o[7] == np.float32(0.9)
    assert s_o[5] and s_o[7]


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_integrate_duplicates_inside_to_score(seed):
    """Repeated ids inside to_score: only the first occurrence is fresh
    and its score is the one written (the serial kernel's rule)."""
    rng = np.random.default_rng(seed)
    cand, scored, scores, enqueued, row = make_case(rng, n=128, k=128)
    to_score = rng.integers(-1, 128, size=128).astype(np.int32)
    to_score[64:] = to_score[:64]
    new_scores = rng.random(128).astype(np.float32)
    got, want = _integrate_both(to_score, new_scores, cand, row, scored,
                                scores, enqueued)
    _assert_outputs_equal(got, want)
    fresh = got[3]
    assert fresh[:64].sum() > 0 and not fresh[64:].any()


@pytest.mark.parametrize("kt", [1, 16, 100])
def test_integrate_narrow_to_score(kt):
    """kt < kc: to_score is the front of the filter's output."""
    rng = np.random.default_rng(9)
    cand, scored, scores, enqueued, row = make_case(rng)
    to_score = np.asarray(candidate_filter_pallas(
        jnp.asarray(cand), jnp.asarray(scored), interpret=True))[:kt]
    new_scores = rng.random(kt).astype(np.float32)
    got, want = _integrate_both(to_score, new_scores, cand, row, scored,
                                scores, enqueued)
    _assert_outputs_equal(got, want)
    assert got[3].shape == (kt,) and got[4].shape == cand.shape


def test_cpu_wrappers_update_in_place_and_never_count():
    rng = np.random.default_rng(10)
    cand, scored, scores, enqueued, row = make_case(rng)
    launches = (ops.candidate_filter.launches,
                ops.integrate_candidates.launches)
    tabs = [_t(scored), _t(scores), _t(enqueued)]
    ts = ops.candidate_filter(_t(cand), tabs[0])
    out = ops.integrate_candidates(ts, torch.rand(ts.shape[0]), _t(cand),
                                   _t(row), *tabs)
    for table, returned in zip(tabs, out[:3]):
        assert returned is table
    assert bool(tabs[0][ts[ts >= 0].long()].all())
    assert (ops.candidate_filter.launches,
            ops.integrate_candidates.launches) == launches
    with pytest.raises(ValueError):
        ops.candidate_filter(_t(cand).long(), tabs[0])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _cuda_case(kind: str, k: int):
    """The recipe of ``make_case`` at three shapes (``"n,k,n_rows"``, the
    second the 1M graph's), else an :func:`edge_case`."""
    if kind.count(",") == 2:
        n, kk, n_rows = map(int, kind.split(","))
        rng = np.random.default_rng(11)
        cand, scored, scores, enqueued, row = make_case(rng, n=n, k=kk,
                                                        n_rows=n_rows)
        ts = serial_filter(cand, scored)
        return (ts, rng.random(kk).astype(np.float32), cand, row, scored,
                scores, enqueued)
    return edge_case(kind, k)


# past 8,192 candidates the dedup table leaves shared memory
CUDA_CASES = [("512,256,700", 0), (f"{1 << 20},2048,{(1 << 20) + 66610}", 0),
              ("5000,3000,5300", 0),
              *[("random", k) for k in (1, 1023, 1025, 4097, 8192, 8193,
                                        32768)],
              *[(kind, k) for kind in ("one id", "last id", "out of range")
                for k in (2048, 32768)]]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,k", CUDA_CASES)
def test_cuda_candidate_filter_equals_twin(cuda, kind, k):
    _, _, cand, _, scored, _, _ = _cuda_case(kind, k)
    before = ops.candidate_filter.launches
    want = ops.candidate_filter_plain(_t(cand), _t(scored))
    for _ in range(2):   # two calls in a row: no state between them
        got = ops.candidate_filter(_t(cand, cuda), _t(scored, cuda))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
    assert ops.candidate_filter.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("kind,k,narrow", [
    *[(kind, k, None) for kind, k in CUDA_CASES],
    (f"{1 << 20},2048,{(1 << 20) + 66610}", 0, 1024), ("5000,3000,5300", 0,
                                                       "dup"),
    ("random", 32768, 10000), ("phase B invalid", 2048, None),
    ("phase B invalid", 32768, None), ("kt 0", 2048, None),
    ("kt 0", 32768, None)])
def test_cuda_integrate_equals_twin(cuda, kind, k, narrow):
    """Every output and every table; ``narrow``: ``to_score``'s first
    entries only (kt < kc), or ``"dup"``: its second half a copy of the
    first."""
    ts, new_scores, cand, row, scored, scores, enqueued = _cuda_case(kind, k)
    if narrow == "dup":
        ts[len(ts) // 2:] = ts[: len(ts) - len(ts) // 2]
    elif narrow is not None:
        ts, new_scores = ts[:narrow], new_scores[:narrow]
    before = ops.integrate_candidates.launches
    want = ops.integrate_candidates_plain(*[_t(a) for a in (
        ts, new_scores, cand, row, scored, scores, enqueued)])
    for _ in range(2):   # two calls in a row: no state between them
        got = ops.integrate_candidates(*[_t(a, cuda) for a in (
            ts, new_scores, cand, row, scored, scores, enqueued)])
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, NAMES):
            assert torch.equal(g.cpu(), w), name
    assert ops.integrate_candidates.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2048, 32768])
def test_cuda_calls_allocate_nothing_sized_by_the_library(cuda, k):
    """At N = 1M a call's device memory grows by its outputs and, past
    8,192 candidates, the per-call table (freed on return): nothing sized
    by N or R stays behind or is taken."""
    n, n_rows = 1_000_000, 1_066_610
    rng = np.random.default_rng(14)
    cand, scored, scores, enqueued, row = [
        _t(a, cuda) for a in make_case(rng, n=n, k=k, n_rows=n_rows)]
    new_scores = torch.rand(k, device=cuda)
    log2, shared = ops._dedup_table(k)
    table = 0 if shared else 8 << log2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    ts = ops.candidate_filter(cand, scored)
    out = ops.integrate_candidates(ts, new_scores, cand, row, scored, scores,
                                   enqueued)
    torch.cuda.synchronize()
    outputs = 4 * k + 6 * k   # K1's ids; K2's fresh, push and cand_score
    slack = 4 * 512           # the allocator's rounding, per block
    assert torch.cuda.memory_allocated(cuda) - base <= outputs + slack
    assert torch.cuda.max_memory_allocated(cuda) - base <= \
        outputs + table + slack + 512
    del out
