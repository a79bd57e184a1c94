"""The cluster-probed build through the API (``HNSWIndex.build(probes=)``)
against the plain reference of the benchmark's probed cell
(``portbench.reference.build_probed``), on the CPU with small blocks: edge
for edge and node order for node order on two seeds, a planted fault in
one probe list that breaks it, the probed layer's spans and counters, and
a reference that loads nothing of the program or of JAX."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.gen.library import make_library
from portbench.reference import build_probed as ref
from rad_tpu_torch.api.index import HNSWIndex
from rad_tpu_torch.build import exact, probe
from rad_tpu_torch.utils.profiling import recording

ROOT = Path(__file__).resolve().parents[1]
N, BITS, M = 12_000, 256, 8
# 24 clusters of 512 rows (4 x 4 needed), the last with 288 pads; layers
# from 512 nodes on take the bucket scan, as from 8,192 at the defaults
PROBED = dict(probes=4, probe_csize=512, probe_sample=16,
              probe_granularity="qblock", q_block=128, col_block=512,
              sel_block=128, probe_min_n=0)
SEEDS = [0, 7]
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def library():
    return make_library(N, BITS, seed=5)[0]


def _build(packed, seed, **kw):
    idx = HNSWIndex(ndim=BITS, connectivity=M, seed=seed, device=CPU)
    idx.add(np.arange(len(packed)), packed)
    return idx.build(**PROBED, **kw)


def _reference(packed, seed):
    return ref.build(packed, M, seed, CPU, PROBED["probes"],
                     PROBED["probe_csize"], PROBED["probe_sample"],
                     PROBED["q_block"], PROBED["probe_min_n"],
                     col_block=PROBED["col_block"],
                     sel_block=PROBED["sel_block"])


@pytest.fixture(scope="module")
def built(library):
    """Per seed: the program's graph (built under ``recording()``, with
    the spans it opened), its stage times and the reference's graph."""
    out = {}
    for seed in SEEDS:
        opened = []
        real = exact.span

        def spy(name):
            opened.append(name)
            return real(name)

        times = {}
        exact.span = spy
        try:
            with recording() as rec:
                g = _build(library, seed, stage_times=times)
        finally:
            exact.span = real
        out[seed] = (g, times, rec.counters, opened,
                     _reference(library, seed))
    return out


def _differences(g, reference):
    order, levels, neighbours, _ = reference
    nodes = int((np.asarray(g.keys) != order).sum()
                + (np.asarray(g.levels) != levels).sum())
    edges = sum(int((np.asarray(a) != b).sum())
                for a, b in zip(g.neighbors, neighbours))
    return nodes, edges


@pytest.mark.parametrize("seed", SEEDS)
def test_probed_build_equals_the_reference(built, seed):
    g, times, _, _, reference = built[seed]
    assert g.layer_sizes == tuple(len(nb) for nb in reference[2])
    assert times["probed_layers"] == reference[3] == [0]
    assert _differences(g, reference) == (0, 0)


def test_changed_probe_list_breaks_the_equality(library, built,
                                                monkeypatch):
    real = probe.qblock_probes

    def planted(*a, **kw):
        tab = real(*a, **kw).copy()
        # q-block 3 scans another cluster in place of its last listed one
        others = np.setdiff1d(np.arange(tab.max() + 1), tab[3])
        tab[3, -1] = others[-1]
        tab[3] = np.sort(tab[3])
        return tab

    monkeypatch.setattr(probe, "qblock_probes", planted)
    g = _build(library, SEEDS[0])
    nodes, edges = _differences(g, built[SEEDS[0]][4])
    assert nodes == 0 and edges > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_probed_layer_spans_and_counters(built, seed):
    g, _, counters, opened, _ = built[seed]
    qblocks = -(-g.layer_sizes[0] // PROBED["q_block"])
    assert counters["build.probe_qblocks"] == qblocks
    assert counters["build.probe_bucket"] == qblocks * PROBED["probes"]
    assert "build.probe_matrix" not in counters
    assert opened.count("build.bisection") == 1
    assert opened.count("build.probe_tables") == 1
    assert opened.count("build.probe_scan") == qblocks


def test_matrix_path_counts_its_cluster_scans(library):
    # without the bucket reduction each cluster scan takes the matrix
    kw = dict(PROBED, block_bucket=None)
    packed = library[:4_000]
    idx = HNSWIndex(ndim=BITS, connectivity=M, seed=1, device=CPU)
    idx.add(np.arange(len(packed)), packed)
    kw.update(probe_csize=128, q_block=128, col_block=128)
    with recording() as rec:
        g = idx.build(**kw)
    qblocks = -(-g.layer_sizes[0] // 128)
    assert rec.counters["build.probe_qblocks"] == qblocks
    assert rec.counters["build.probe_matrix"] == qblocks * kw["probes"]
    assert "build.probe_bucket" not in rec.counters


def test_build_without_recording_or_stage_times_is_the_same(library,
                                                            built):
    g = _build(library, SEEDS[1])
    assert _differences(g, built[SEEDS[1]][4]) == (0, 0)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, portbench.reference.build_probed; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'rad_tpu', 'rad_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"
