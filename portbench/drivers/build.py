"""Whole index builds of one library, back to back.

Each unit is ``HNSWIndex(...).add(keys, fingerprints)`` and ``build()``
on the card, with the configuration's connectivity and expansion; a build
starts only while the last one's time says it ends within the window (one
always runs). The library is made on the host from the seed. Every build
of the window is held edge for edge to the reference build
(``portbench.reference.build``) of the same library.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.drivers import Parts, closed_loop, mismatches, sync
from portbench.gen import sub_seed
from portbench.gen.library import make_library
from portbench.reference import build as ref
from portbench.trace import busy_within


def make(config, traffic, seed, device):
    return Build(config, traffic, seed, device)


def library(config, seed):
    """The configuration's library: (packed, scores, keys)."""
    packed, scores = make_library(
        int(config["n_molecules"]), int(config["ndim"]),
        mutation=float(config["mutation"]), density=float(config["density"]),
        seed=sub_seed(seed, 1))
    return packed, scores, np.arange(len(packed), dtype=np.int64)


def new_index(config, device):
    from rad_tpu_torch.api.index import HNSWIndex

    return HNSWIndex(ndim=int(config["ndim"]),
                     connectivity=int(config["connectivity"]),
                     expansion_add=int(config["expansion_add"]),
                     seed=int(config["level_seed"]), device=device)


class StageClock(dict):
    """A ``stage_times`` dict that notes when each stage's seconds were
    added, and marks that moment in the trace."""

    def __init__(self, tracer):
        super().__init__()
        self.tracer = tracer
        self.events = []

    def __setitem__(self, key, value):
        added = value - self.get(key, 0.0)
        i = len(self.events)
        self.events.append((key, self.tracer.mark(str(i)), added, i))
        super().__setitem__(key, value)

    def candidate_spans(self, n_layers: int):
        """Host-clock (start, end, mark index, mark's host clock) of each
        layer's candidates stage: it ends where that layer's selection began, and lasts the
        seconds the layer added to ``"candidates"``.

        The spans rest on the order in which ``build()`` writes
        ``stage_times``: for each of the ``n_layers`` layers it scans,
        selection, then candidates net of selection, then symmetrization.
        Any other order or count raises, so that a change to that
        bookkeeping fails the traced run instead of moving the metric."""
        keys = [key for key, *_ in self.events]
        want = ["selection", "candidates", "symmetrization"] * n_layers
        if keys != want:
            raise RuntimeError(
                "candidates_roofline_pct.build: build() wrote stage_times "
                f"as {keys}, not {want}; the candidates spans cannot be "
                "placed")
        out = []
        for j in range(n_layers):
            (_, t_sel, sel_added, i_sel), (_, _, cand_added, _) = \
                self.events[3 * j: 3 * j + 2]
            end = t_sel - sel_added
            out.append((end - cand_added, end, i_sel, t_sel))
        return out


class Build:
    def __init__(self, config, traffic, seed, device):
        self.cfg, self.tr, self.seed, self.device = config, traffic, seed, \
            device
        self.graphs = []

    def setup(self):
        clock = Parts(self.device)
        self.parts = clock.parts
        self.packed, _, self.keys = library(self.cfg, self.seed)
        clock.done("library")
        warm = int(self.tr["warmup_rows"])
        idx = new_index(self.cfg, self.device)
        idx.add(self.keys[:warm], self.packed[:warm])
        idx.build()
        del idx
        clock.done("warmup_build")

    def window(self, seconds, tracer, control=False):
        self.graphs = []
        times, cand, sel = [], [], []

        def unit(i):
            t0 = time.perf_counter()
            if control:
                order, levels, nb = ref.build(
                    self.packed, int(self.cfg["connectivity"]),
                    int(self.cfg["level_seed"]), self.device,
                    sim_dtype=torch.bfloat16)
                self.graphs.append((self.keys[order], levels, nb))
                times.append(time.perf_counter() - t0)
                return
            clock = StageClock(tracer) if tracer.enabled else None
            with tracer.span("build"):
                idx = new_index(self.cfg, self.device)
                idx.add(self.keys, self.packed)
                g = idx.build(**({} if clock is None
                                 else {"stage_times": clock}))
            sync(self.device)
            times.append(time.perf_counter() - t0)
            self.graphs.append((np.asarray(g.keys), np.asarray(g.levels),
                                [np.asarray(t) for t in g.neighbors]))
            self.layer_sizes = list(g.layer_sizes)
            if clock is not None:
                cand.append(clock["candidates"])
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
                    "k": max(4 * int(self.cfg["connectivity"]), 32),
                    "layer_sizes": getattr(self, "layer_sizes", [])}
        if cand:
            counters["candidates_s"] = cand
            counters["selection_s"] = sel
        if tracer.summary is not None and getattr(self, "_clock", None):
            counters["candidates_device_s"] = self._candidates_device_s(
                tracer.summary)
        return counters

    def _candidates_device_s(self, summary):
        """Device seconds inside the traced build's candidates stages: the
        host-clock spans moved onto the profiler's clock by the marks."""
        total = 0.0
        n_layers = sum(1 for n in self.layer_sizes if n > 1)
        for start, end, mark, t_mark in self._clock.candidate_spans(n_layers):
            ns = summary["marks"].get(f"pb.mark.{mark}")
            if ns is None:
                raise RuntimeError(
                    f"candidates_roofline_pct.build: mark pb.mark.{mark} "
                    "is not in the trace")
            offset = ns - t_mark * 1e9
            total += busy_within(summary, start * 1e9 + offset,
                                 end * 1e9 + offset)
        return total or None

    def release(self):
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        order, levels, nb = ref.build(
            self.packed, int(self.cfg["connectivity"]),
            int(self.cfg["level_seed"]), self.device)
        keys = self.keys[order]
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
