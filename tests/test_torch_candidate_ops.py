"""rad_tpu_torch's fused candidate kernels (K1/K2) against rad_tpu's.

On the CPU the wrappers run their plain twins, which must be array-equal
to ``candidate_filter_pallas`` / ``integrate_candidates_pallas`` in
interpret mode: the ids and masks are integers and the scores are copied
or gathered, so the tolerance is exact. The cases are those of
``tests/test_pallas_ops.py`` plus duplicates inside ``to_score`` (the
serial kernel marks only the first occurrence fresh) and a ``to_score``
narrower than the candidates (``fused_run``'s ``narrow_width``). The
``gpu`` tests hold each CUDA kernel to its twin on the card.
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


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,n_rows", [(512, 256, 700), (1 << 20, 2048,
                                                          (1 << 20) + 66610),
                                        (5000, 3000, 5300)])
def test_cuda_candidate_filter_equals_twin(cuda, n, k, n_rows):
    rng = np.random.default_rng(11)
    cand, scored, *_ = make_case(rng, n=n, k=k, n_rows=n_rows)
    before = ops.candidate_filter.launches
    for _ in range(2):   # the second call finds the scratch restored
        got = ops.candidate_filter(_t(cand, cuda), _t(scored, cuda))
        torch.cuda.synchronize()
        want = ops.candidate_filter_plain(_t(cand), _t(scored))
        assert torch.equal(got.cpu(), want)
    assert ops.candidate_filter.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,n_rows,kt,dup", [
    (512, 256, 700, 256, False), ((1 << 20), 2048, (1 << 20) + 66610, 2048,
                                  False),
    ((1 << 20), 2048, (1 << 20) + 66610, 1024, False),
    (5000, 3000, 5300, 3000, True)])
def test_cuda_integrate_equals_twin(cuda, n, k, n_rows, kt, dup):
    rng = np.random.default_rng(12)
    cand, scored, scores, enqueued, row = make_case(rng, n=n, k=k,
                                                    n_rows=n_rows)
    ts = ops.candidate_filter_plain(_t(cand), _t(scored)).numpy()[:kt]
    if dup:
        ts[kt // 2:] = ts[: kt - kt // 2]
    new_scores = rng.random(kt).astype(np.float32)
    before = ops.integrate_candidates.launches
    for _ in range(2):   # the second call finds the scratch restored
        got = ops.integrate_candidates(*[_t(a, cuda) for a in (
            ts, new_scores, cand, row, scored, scores, enqueued)])
        torch.cuda.synchronize()
        want = ops.integrate_candidates_plain(*[_t(a) for a in (
            ts, new_scores, cand, row, scored, scores, enqueued)])
        for g, w, name in zip(got, want, NAMES):
            assert torch.equal(g.cpu(), w), name
    assert ops.integrate_candidates.launches == before + 2
