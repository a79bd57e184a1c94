"""Each driver against the reference at small sizes on the CPU (the
program's kernels through their plain twins), the control that must come
out not correct, and the faults planted under the timed path that must
too. The cells' own sizes run on the card (``test_cuda_*``)."""

from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.reference import traverse as ref

CPU = torch.device("cpu")
SHARD = dict(n_nodes=20_000, batch=64, n_to_score=2_500,
             frontier_capacity=2048, head_capacity=256, buffer_capacity=128)
TREE = dict(n_molecules=9_000, warmup_rows=8_192)
CELLS = {"shard333m_m8.tanimoto_b1024": SHARD,
         "shard333m_m8.table_b1024": SHARD,
         "tree1m_m16.build": TREE}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    torch.set_num_threads(4)


def _run(spec, cell, seed=2 ** 31 + 99, seconds=0.5, **kw):
    line = run.run_cell(spec, cell, seed, seconds, False, CPU,
                        sizes=CELLS[cell], **kw)
    assert line.pop("_forbidden") == []
    return line


@pytest.mark.parametrize("cell", list(CELLS))
def test_driver_matches_the_reference(table_spec, cell):
    line = _run(table_spec, cell)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert all(c["value"] == 0 for c in line["checks"].values())


@pytest.mark.parametrize("cell", list(CELLS))
def test_control_is_not_correct(table_spec, cell):
    line = _run(table_spec, cell, control=True)
    assert line["correct"] is False
    assert max(c["value"] for c in line["checks"].values()) > 0


def test_traced_run_reports_the_per_layer_metrics_it_can(table_spec):
    line = run.run_cell(table_spec, "tree1m_m16.build", 5, 0.5, True, CPU,
                        sizes=TREE)
    # the CPU has no device trace: only the stage counters read
    assert set(line["metrics"]) == {"candidates_s.build",
                                    "selection_s.build"}
    assert line["correct"] is True


# -- faults under the timed path ---------------------------------------------

def _alter_one_score(monkeypatch):
    """One molecule's score one ulp off where it is produced."""
    from rad_tpu_torch.traverse import device as tdev

    real = tdev.integrate

    def integrate(state, dg, *args, **kw):
        args = list(args)
        if int(state.n_steps) == 2:   # every campaign's second step
            scores = args[6].clone()
            scores[0] = torch.nextafter(scores[0], torch.tensor(2.0))
            args[6] = scores
        return real(state, dg, *args, **kw)

    monkeypatch.setattr(tdev, "integrate", integrate)


def _half_batch(monkeypatch):
    from rad_tpu_torch.traverse import device as tdev

    real = tdev.expand
    monkeypatch.setattr(tdev, "expand", lambda state, dg, batch, **kw:
                        real(state, dg, max(batch // 2, 1), **kw))


def _one_step_unchanged(monkeypatch):
    from rad_tpu_torch.traverse import device as tdev

    real = tdev.integrate

    def integrate(state, *args, **kw):
        # every campaign's second step leaves the state as it found it
        return state if int(state.n_steps) == 2 else real(state, *args,
                                                           **kw)

    monkeypatch.setattr(tdev, "integrate", integrate)


def _build_alter_edge(monkeypatch):
    from rad_tpu_torch.build import exact

    real = exact._symmetrize

    def sym(*a, **kw):
        rows = real(*a, **kw).clone()
        rows[0, 0] = (rows[0, 0] + 1) % rows.shape[0]
        return rows

    monkeypatch.setattr(exact, "_symmetrize", sym)


def _build_half_batch(monkeypatch):
    from rad_tpu_torch.build import exact

    real = exact._allpairs_topk

    def topk(packed, pops, n_real, k, *a, **kw):
        d, i = real(packed, pops, n_real, k, *a, **kw)
        half = n_real // 2
        d[half:] = float("inf")
        i[half:] = -1
        return d, i

    monkeypatch.setattr(exact, "_allpairs_topk", topk)


def _build_stage_unchanged(monkeypatch):
    from rad_tpu_torch.build import exact

    def sym(sel, sel_d, n_real, cap):
        out = torch.full((sel.shape[0], cap), -1, dtype=torch.int32,
                         device=sel.device)
        out[:, : sel.shape[1]] = sel
        return out

    monkeypatch.setattr(exact, "_symmetrize", sym)


TRAVERSAL_FAULTS = [_alter_one_score, _half_batch, _one_step_unchanged]
BUILD_FAULTS = [_build_alter_edge, _build_half_batch,
                _build_stage_unchanged]


@pytest.mark.parametrize("fault", TRAVERSAL_FAULTS)
@pytest.mark.parametrize("cell", ["shard333m_m8.tanimoto_b1024",
                                  "shard333m_m8.table_b1024"])
def test_traversal_fault_is_not_correct(table_spec, monkeypatch, cell,
                                       fault):
    fault(monkeypatch)
    line = _run(table_spec, cell)
    assert line["correct"] is False
    assert line["failed"] >= 1


@pytest.mark.parametrize("fault", BUILD_FAULTS)
def test_build_fault_is_not_correct(table_spec, monkeypatch, fault):
    fault(monkeypatch)
    line = _run(table_spec, "tree1m_m16.build")
    assert line["correct"] is False


def test_reference_first_occurrence():
    v = torch.tensor([5, 3, 5, 9, 3, 9, 0])
    got = ref.first_occurrence(v, 9)
    assert got.tolist() == [True, True, False, False, False, False, True]


# -- on the card, at sizes a test run holds -----------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(CELLS))
def test_cuda_driver_matches_the_reference_and_control_fails(table_spec,
                                                              cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    sizes = dict(CELLS[cell])
    if cell.startswith("shard"):
        sizes.update(n_nodes=2_000_000, batch=1024, n_to_score=100_000,
                     frontier_capacity=1 << 18, head_capacity=1 << 14,
                     buffer_capacity=1 << 13)
    else:
        sizes.update(n_molecules=100_000, warmup_rows=16_384)
    for control in (False, True):
        line = run.run_cell(table_spec, cell, 2 ** 31 + 3, 1.0, False, dev,
                            control=control, sizes=sizes)
        assert line["correct"] is (not control), line["checks"]
