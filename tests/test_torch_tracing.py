"""The port's spans and counters (rad_tpu_torch.utils.profiling): off
unless a ``recording()`` block is open; inside one, the traversal step's
spans nest once a step, every host read-back of the step is counted by
site, and the exact build writes one span a stage and layer. Recording
changes no result: orders, scores, edges and the order of ``stage_times``
are those of a run without it."""

import numpy as np
import pytest
import torch

from rad_tpu_torch.build.exact import build_hnsw_exact
from rad_tpu_torch.fp.pack import random_fingerprints, to_torch_packed
from rad_tpu_torch.fp.tanimoto import tanimoto_rows_to_target
from rad_tpu_torch.traverse import device as dev
from rad_tpu_torch.traverse.driver import DeviceTraverser
from rad_tpu_torch.utils import profiling
from rad_tpu_torch.utils.profiling import count, recording, span

TARGET = 17
# two-level: head 64 of a 4,096 frontier; batch 4 pushes at most
# 4 * 8 + 4 = 36 entries a step, under the 64-entry buffer, so every
# integrate reads the merge check
TWO_LEVEL = dict(frontier_capacity=1 << 12, head_capacity=64,
                 buffer_capacity=64)
BATCH = 4
STEP_SPANS = ["rad.step.expand", "rad.step.score", "rad.step.integrate"]


@pytest.fixture(scope="module")
def case():
    fps = random_fingerprints(300, n_bits=128, density=0.3, seed=9)
    g = build_hnsw_exact(fps, connectivity=4, seed=1, device="cpu")
    dg = dev.prepare_device_graph(g, "cpu")
    packed = to_torch_packed(np.asarray(g.packed), "cpu")
    pops = torch.from_numpy(np.asarray(g.popcounts).astype(np.int32))
    return g, dg, packed, pops


def _primed(case):
    g, dg, packed, pops = case
    n_top = g.layer_sizes[g.max_level]
    seeds = torch.arange(n_top, dtype=torch.int32)
    return dev.prime(dev.init_state(dg, **TWO_LEVEL), dg, seeds,
                     tanimoto_rows_to_target(
                         packed[:n_top], pops[:n_top], packed[TARGET],
                         pops[TARGET]))


def _fused_run(case, narrow=None):
    _, dg, packed, pops = case
    st = _primed(case)
    steps0 = int(st.n_steps)
    st = dev.fused_run(st, dg, packed, pops, packed[TARGET], pops[TARGET],
                       250, batch=BATCH, narrow_width=narrow)
    return st, int(st.n_steps) - steps0


def _order_scores(st):
    order = dev.read_order_log(st)
    return order, dev.gather_scores(st, order)


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def test_span_is_the_shared_null_context_while_off():
    assert profiling._RECORDING.get() is None
    a, b = span("step"), span("build.candidates")
    assert a is b is profiling._NULL_SPAN
    with a as entered:
        assert entered is None
    count("step", 5)
    with recording() as rec:
        assert rec.counters == {}
        assert span("step") is not profiling._NULL_SPAN
    assert span("step") is profiling._NULL_SPAN


def test_no_rad_event_under_a_profiler_while_off(case):
    (st, steps), events = _profiled(lambda: _fused_run(case))
    assert steps > 0
    assert not [e.name for e in events if e.name.startswith("rad.")]


def test_nested_recording_shares_the_open_one():
    with recording() as outer:
        count("a")
        with recording() as inner:
            count("a", 2)
        assert inner is outer
    assert outer.counters == {"a": 3}


@pytest.mark.parametrize("narrow", [None, 8])
def test_two_level_run_counts_every_read_back_by_site(case, narrow):
    """A step of a two-level state reads the device three times: the loop
    condition, the refill check and the merge check (four with
    ``narrow_width``); the loop's last read ends it."""
    plain, steps = _fused_run(case, narrow)
    assert plain.cold_score.shape[0] > 1 and int(plain.cold_n) > 0
    with recording() as rec:
        st, steps_on = _fused_run(case, narrow)
    assert steps_on == steps > 0
    want = {"step": steps, "sync.loop": steps + 1,
            "sync.refill_check": steps, "sync.merge_check": steps}
    if narrow is not None:
        want["sync.narrow"] = steps
    assert rec.counters == want
    for a, b in zip(_order_scores(st), _order_scores(plain)):
        np.testing.assert_array_equal(a, b)
    assert a.dtype == np.float32


def test_step_spans_nest_once_a_step_in_order(case):
    with recording() as rec:
        (_, steps), events = _profiled(lambda: _fused_run(case))
    step_spans = [e for e in events if e.name == "rad.step"]
    # every step, and the loop read that ends the run
    assert len(step_spans) == steps + 1
    children = [[c.name for c in sorted(e.cpu_children,
                                        key=lambda c: c.time_range.start)
                 if c.name in STEP_SPANS] for e in step_spans]
    assert children[:-1] == [STEP_SPANS] * steps
    assert children[-1] == []
    inner = [e for e in events if e.name in ("rad.step.refill",
                                             "rad.step.merge")]
    assert inner and all(e.cpu_parent.name in STEP_SPANS for e in inner)
    reads = [e for e in events if e.name.startswith("rad.sync.")]
    assert len(reads) == sum(v for k, v in rec.counters.items()
                             if k.startswith("sync."))


class KeyLog(dict):
    """A ``stage_times`` dict that keeps the order of its writes."""

    def __init__(self):
        super().__init__()
        self.writes = []

    def __setitem__(self, key, value):
        self.writes.append(key)
        super().__setitem__(key, value)


# exact: every layer scanned whole; probed: layer 0 by 2 probes of
# 128-row clusters (10 of them), selection streamed into the scan
BUILDS = {
    "exact": dict(connectivity=8, seed=3),
    "probed": dict(connectivity=8, seed=3, probes=2, probe_csize=128,
                   q_block=128, col_block=128, sel_block=128,
                   probe_min_n=0),
}


@pytest.fixture(scope="module")
def library():
    return random_fingerprints(1200, n_bits=128, density=0.3, seed=5)


@pytest.mark.parametrize("kind", sorted(BUILDS))
def test_build_writes_a_span_a_stage_and_layer(library, kind):
    kw = BUILDS[kind]
    off = KeyLog()
    g_off = build_hnsw_exact(library, stage_times=off, device="cpu", **kw)
    on = KeyLog()
    with recording():
        g_on, events = _profiled(lambda: build_hnsw_exact(
            library, stage_times=on, device="cpu", **kw))
    # the order StageClock rests on does not move
    assert on.writes == off.writes
    for a, b in zip(g_on.neighbors, g_off.neighbors):
        np.testing.assert_array_equal(a, b)
    scanned = sum(1 for n in g_on.layer_sizes if n > 1)
    names = [e.name for e in events if e.name.startswith("rad.build.")]
    assert names.count("rad.build.candidates") == scanned
    assert names.count("rad.build.symmetrization") == scanned
    selection = [e for e in events if e.name == "rad.build.selection"]
    probed = off.get("probed_layers", [])
    assert probed == ([0] if kind == "probed" else [])
    nested = [e for e in selection
              if e.cpu_parent is not None
              and e.cpu_parent.name == "rad.build.candidates"]
    assert len(selection) - len(nested) == scanned - len(probed)
    assert (len(nested) > 0) == bool(probed)


def _score(smiles: str) -> float:
    return float((int(smiles) * 2654435761) % (1 << 31)) / (1 << 31)


@pytest.mark.parametrize("depth", [1, 2])
def test_device_traverser_counts_its_downloads(case, depth):
    """The pipelined driver copies each step's ids and valid mask to the
    host: two ``sync.download`` a ``step``."""
    g = case[0]
    t = DeviceTraverser(g, _score, batch_size=8, n_score_threads=1,
                        device="cpu")
    try:
        t.prime()
        with recording() as rec:
            stats = t.traverse(n_to_score=120, pipeline_depth=depth)
    finally:
        t.shutdown()
    c = rec.counters
    assert c["step"] >= stats["steps"] > 0
    assert c["sync.download"] == 2 * c["step"]
