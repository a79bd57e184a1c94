"""Whole cluster-probed index builds of one library, back to back.

Each unit is ``HNSWIndex(...).add(keys, fingerprints)`` and ``build(probes=,
probe_csize=, probe_sample=, probe_granularity=, q_block=, probe_min_n=)``
on the card, with the configuration's values; a build starts only while
the last one's time says it ends within the window (one always runs). Set-up
holds the configuration to the program's rule for a probed layer and warms
up with one probed build of ``warmup_rows`` rows (``probe_min_n=0``).
Where set-up finds the program's kernels still compiling (a fresh
checkout), it makes the reference build while they compile, in place of
after the window. A traced build passes ``stage_times``, whose writes
place the probed scan's spans in the trace, and must list layer 0 among
its probed layers. Every build of the window is held edge for edge to the
reference build (``portbench.reference.build_probed``) of the same
library.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from portbench.drivers import Parts, closed_loop, mismatches, sync
from portbench.drivers.build import StageClock, library, new_index
from portbench.reference import build_probed as ref


def make(config, traffic, seed, device):
    return BuildProbed(config, traffic, seed, device)


def candidates_k(config) -> int:
    """The candidates a node keeps: ``build_hnsw_exact``'s default."""
    return max(4 * int(config["connectivity"]), 32)


def build_kwargs(config) -> dict:
    """The probed build's arguments beyond the index's."""
    return dict(probes=int(config["probes"]),
                probe_csize=int(config["probe_csize"]),
                probe_sample=int(config["probe_sample"]),
                probe_granularity=config["probe_granularity"],
                q_block=int(config["q_block"]),
                probe_min_n=int(config["probe_min_n"]))


def check_layer_probes(config, n: int, probe_min_n: int) -> None:
    """Raises unless a layer of ``n`` nodes takes the probed scan under
    the program's rule."""
    probes, csize = int(config["probes"]), int(config["probe_csize"])
    q_block, k = int(config["q_block"]), candidates_k(config)
    if config["probe_granularity"] != "qblock" or not ref.probes_layer(
            n, k, probes, csize, q_block, probe_min_n):
        raise RuntimeError(
            f"build_probed: a layer of {n:,} nodes would not probe "
            f"(probe_min_n {probe_min_n:,}, {-(-n // csize)} clusters of "
            f"{csize} against 4 x {probes}, k {k}, q_block {q_block}, "
            f"granularity {config['probe_granularity']!r})")


class Compile(threading.Thread):
    """Loads the program's kernel library on another thread (on the card
    only): in a fresh checkout that is the kernels' compilation, which then
    overlaps what set-up makes on the host."""

    def __init__(self, device):
        super().__init__(daemon=True)
        self.device, self.error = device, None
        self.start()

    def run(self):
        if self.device.type != "cuda":
            return
        from rad_tpu_torch import _cuda

        try:
            _cuda.load_library()
        except BaseException as e:      # raised again by wait()
            self.error = e

    def wait(self):
        self.join()
        if self.error is not None:
            raise self.error


class ProbedClock(StageClock):
    """The build cell's ``stage_times`` clock, which also takes the list of
    probed layers (not a stage: no event, no mark)."""

    def __setitem__(self, key, value):
        if isinstance(value, float):
            super().__setitem__(key, value)
        else:
            dict.__setitem__(self, key, value)

    def scan_spans(self, layer_sizes, probed, q_block: int):
        """Host-clock (start, end, mark index, mark's host clock) of each
        span of the probed scans: from the write before it to the start of
        the selection it feeds.

        The spans rest on the order in which ``build()`` writes
        ``stage_times``, layer by layer from layer 0, for each layer it
        scans: on a probed layer ``"bisection"``, ``"probe_tables"``, then
        ``"selection"`` once for each group of q-blocks (after a device
        synchronisation, so a group's scan lies between the write before
        and the start of the seconds it adds), then ``"candidates"`` and
        ``"symmetrization"``; on an exact layer ``"selection"``,
        ``"candidates"``, ``"symmetrization"``. Any other order or count
        raises, so that a change to that bookkeeping fails the traced run
        instead of moving the metric."""
        events = self.events
        pos = 0

        def take(key):
            nonlocal pos
            if pos >= len(events) or events[pos][0] != key:
                raise RuntimeError(
                    "probe_scan_device_s.build_probed: build() wrote "
                    f"stage_times as {[e[0] for e in events]}; "
                    f"{key!r} expected at write {pos} (probed layers "
                    f"{list(probed)}): the scan spans cannot be placed")
            pos += 1
            return events[pos - 1]

        out = []
        for layer, n_l in enumerate(layer_sizes):
            if n_l <= 1:
                continue
            if layer not in probed:
                take("selection")
            else:
                take("bisection")
                _, prev, _, _ = take("probe_tables")
                groups = 0
                while pos < len(events) and events[pos][0] == "selection":
                    _, t_sel, added, mark = take("selection")
                    out.append((prev, t_sel - added, mark, t_sel))
                    prev = t_sel
                    groups += 1
                if not 1 <= groups <= -(-n_l // q_block):
                    raise RuntimeError(
                        "probe_scan_device_s.build_probed: layer "
                        f"{layer}'s selection was written {groups} times "
                        f"for {-(-n_l // q_block)} q-blocks")
            take("candidates")
            take("symmetrization")
        if pos != len(events):
            take("end of the build")
        return out


class BuildProbed:
    def __init__(self, config, traffic, seed, device):
        self.cfg, self.tr, self.seed, self.device = config, traffic, seed, \
            device
        self.kw = build_kwargs(config)
        self.graphs = []
        self._ref = None

    def setup(self):
        n = int(self.cfg["n_molecules"])
        check_layer_probes(self.cfg, n, self.kw["probe_min_n"])
        warm = min(int(self.tr["warmup_rows"]), n)
        check_layer_probes(self.cfg, warm, 0)
        clock = Parts(self.device)
        self.parts = clock.parts
        compiling = Compile(self.device)
        self.packed, _, self.keys = library(self.cfg, self.seed)
        clock.done("library")
        if compiling.is_alive():
            self._ref = self._reference()
            self.release()
            clock.done("reference")
        compiling.wait()
        clock.done("kernels")
        idx = new_index(self.cfg, self.device)
        idx.add(self.keys[:warm], self.packed[:warm])
        times = {}
        idx.build(**{**self.kw, "probe_min_n": 0}, stage_times=times)
        if 0 not in times["probed_layers"]:
            raise RuntimeError("build_probed: the warm-up build did not "
                               "probe layer 0")
        del idx
        clock.done("warmup_build")

    def _reference(self, sim_dtype=torch.float32):
        order, levels, nb, probed = ref.build(
            self.packed, int(self.cfg["connectivity"]),
            int(self.cfg["level_seed"]), self.device,
            int(self.cfg["probes"]), int(self.cfg["probe_csize"]),
            int(self.cfg["probe_sample"]), self.kw["q_block"],
            self.kw["probe_min_n"], sim_dtype=sim_dtype)
        if 0 not in probed:
            raise RuntimeError("build_probed: the reference did not probe "
                               "layer 0")
        return self.keys[order], levels, nb

    def window(self, seconds, tracer, control=False):
        self.graphs = []
        times, partition, sel = [], [], []

        def unit(i):
            t0 = time.perf_counter()
            if control:
                self.graphs.append(self._reference(torch.bfloat16))
                times.append(time.perf_counter() - t0)
                return
            clock = ProbedClock(tracer) if tracer.enabled else None
            with tracer.span("build"):
                idx = new_index(self.cfg, self.device)
                idx.add(self.keys, self.packed)
                g = idx.build(**self.kw, **({} if clock is None
                                            else {"stage_times": clock}))
            sync(self.device)
            times.append(time.perf_counter() - t0)
            self.graphs.append((np.asarray(g.keys), np.asarray(g.levels),
                                [np.asarray(t) for t in g.neighbors]))
            self.layer_sizes = list(g.layer_sizes)
            if clock is not None:
                if 0 not in clock["probed_layers"]:
                    raise RuntimeError(
                        "build_probed: layer 0 did not probe (probed "
                        f"layers {clock['probed_layers']})")
                partition.append(clock["bisection"] + clock["probe_tables"])
                sel.append(clock["selection"])
                if i == tracer.start:
                    self._clock = clock
            del idx, g

        units, wall, unit_s = closed_loop(
            seconds, self.device, tracer, unit,
            next_fits=lambda elapsed, last: elapsed + last <= seconds)
        counters = {"units": units, "wall_s": wall, "unit_s": unit_s,
                    "build_rows": units * len(self.packed),
                    "build_s": sum(times), "ndim": int(self.cfg["ndim"]),
                    "k": candidates_k(self.cfg),
                    "layer_sizes": getattr(self, "layer_sizes", [])}
        if partition:
            counters["partition_s"] = partition
            counters["selection_s"] = sel
        clock = getattr(self, "_clock", None)
        if tracer.summary is not None and clock is not None:
            counters["probed_layers"] = list(clock["probed_layers"])
            counters["probe_scan_device_s"] = self._scan_device_s(
                tracer.summary, clock)
        return counters

    def _scan_device_s(self, summary, clock):
        """Device seconds inside the traced build's probed scans: the
        host-clock spans moved onto the profiler's clock by the marks."""
        spans = []
        for start, end, mark, t_mark in clock.scan_spans(
                self.layer_sizes, clock["probed_layers"],
                self.kw["q_block"]):
            ns = summary["marks"].get(f"pb.mark.{mark}")
            if ns is None:
                raise RuntimeError(
                    f"probe_scan_device_s.build_probed: mark pb.mark.{mark}"
                    " is not in the trace")
            offset = ns - t_mark * 1e9
            spans.append((start * 1e9 + offset, end * 1e9 + offset))
        return busy_in_spans(summary["intervals"], spans) or None

    def release(self):
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        keys, levels, nb = (self._ref if self._ref is not None
                            else self._reference())
        totals = dict(edge_mismatch=0, node_order_mismatch=0)
        self.failed = 0
        for g_keys, g_levels, g_nb in self.graphs:
            edges = abs(len(g_nb) - len(nb))
            for a, b in zip(g_nb, nb):
                edges += (int((a != b).sum()) if a.shape == b.shape
                          else max(a.size, b.size))
            nodes = mismatches(g_keys, keys) + mismatches(g_levels, levels)
            totals["edge_mismatch"] += edges
            totals["node_order_mismatch"] += nodes
            self.failed += int(edges + nodes > 0)
        return [{"name": k, "value": v, "limit": 0}
                for k, v in totals.items()]


def busy_in_spans(intervals, spans) -> float:
    """Seconds of the sorted, disjoint device ``intervals`` (ns) inside
    the spans ``[(a, b), ...]`` (ns), summed: ``portbench.trace
    .busy_within`` over each span, by bisection (a traced build has a
    thousand spans and hundreds of thousands of intervals)."""
    iv = np.asarray(intervals, dtype=np.float64).reshape(-1, 2)
    starts, ends = iv[:, 0], iv[:, 1]
    before = np.concatenate([[0.0], np.cumsum(ends - starts)])
    total = 0.0
    for a, b in spans:
        first = int(np.searchsorted(ends, a, side="right"))
        stop = int(np.searchsorted(starts, b, side="left"))
        if stop <= first:
            continue
        total += (before[stop] - before[first]
                  - max(0.0, a - starts[first])
                  - max(0.0, ends[stop - 1] - b))
    return total / 1e9
