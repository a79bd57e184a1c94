"""Device-scored campaigns on a graph made on the card.

Each campaign: ``init_state`` at the traffic's capacities, ``prime`` with
the top layer's nodes, then ``fused_run`` (``scorer: "tanimoto"``, the
Tanimoto distance to the campaign's target row) or ``make_device_run``
with a ``[N]`` f32 table passed as ``pops`` (``scorer: "table"``) at
``batch`` until ``n_to_score`` are scored, and the scored ids in order and
their scores read back to the host: what a screen hands its user.
Campaigns run back to back, one at a time. The graph, the fingerprints,
the table and every target are made from the seed; the reference gets the
same and replays a sample of the window's campaigns.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.drivers import Parts, closed_loop, mismatches
from portbench.gen import sub_seed
from portbench.gen.bits import random_words, uniform_table
from portbench.gen.graph import make_graph, top_ids
from portbench.reference import traverse as ref
from portbench.reference.tanimoto import distance_to_target, popcount_rows
from portbench.trace import Tracer

INF = float("inf")


def make(config, traffic, seed, device):
    return DeviceTraversal(config, traffic, seed, device)


class DeviceTraversal:
    def __init__(self, config, traffic, seed, device):
        self.cfg, self.tr, self.seed, self.device = config, traffic, seed, \
            device
        self.n = int(config["n_nodes"])
        self.m = int(config["connectivity"])
        self.w = int(config["ndim"]) // 32
        self.scorer = traffic["scorer"]
        self.batch = int(traffic["batch"])
        self.budget = int(traffic["n_to_score"])
        self.caps = dict(frontier=int(traffic["frontier_capacity"]),
                         head=int(traffic["head_capacity"]),
                         buffer=int(traffic["buffer_capacity"]))
        self.results = []

    # -- set-up ---------------------------------------------------------------
    def setup(self):
        from rad_tpu_torch.traverse import device as tdev

        dev = self.device
        clock = Parts(dev)
        self.parts = clock.parts
        self.adj, self.offsets, self.sizes = make_graph(
            self.n, self.m, sub_seed(self.seed, 1), dev)
        self.dg = tdev.DeviceGraph(
            adj=self.adj,
            offsets=torch.from_numpy(self.offsets).to(dev, torch.int32),
            offsets_host=self.offsets.astype(np.int32), n_nodes=self.n,
            n_rows=int(self.adj.shape[0]), m0=2 * self.m,
            max_level=len(self.sizes) - 1)
        self.top = torch.arange(top_ids(self.sizes), device=dev)
        clock.done("graph")
        if self.scorer == "tanimoto":
            self.fps = random_words(self.n, self.w, sub_seed(self.seed, 2),
                                    dev)
            self.pops = popcount_rows(self.fps)
            # campaign c's target is fingerprint row targets[c]
            rng = np.random.default_rng(sub_seed(self.seed, 3))
            self.targets = rng.integers(0, self.n, size=1 << 16)
        elif self.scorer == "table":
            self.table = uniform_table(self.n, sub_seed(self.seed, 2), dev)
            self.dummy = torch.zeros((self.n, 1), dtype=torch.uint8,
                                     device=dev)
            self.run_table = tdev.make_device_run(
                self.dg, self.dummy, self.table,
                lambda _rows, table_rows: table_rows, batch=self.batch)
        else:
            raise ValueError(f"unknown scorer {self.scorer!r}")
        clock.done("score_source")
        # warm-up: one whole campaign on a target no window campaign has
        self._campaign(-1, keep=False, tracer=Tracer(False))
        clock.done("warmup")

    # -- the program's campaign ----------------------------------------------
    def _campaign(self, c: int, keep: bool, tracer):
        from rad_tpu_torch.fp.tanimoto import tanimoto_rows_to_target
        from rad_tpu_torch.traverse import device as tdev

        span = tracer.span
        self.state = None
        with span("campaign.init"):
            st = tdev.init_state(
                self.dg, frontier_capacity=self.caps["frontier"],
                buffer_capacity=self.caps["buffer"],
                head_capacity=self.caps["head"])
            if self.scorer == "tanimoto":
                t = int(self.targets[c])
                target = self.fps[t]
                t_pop = self.pops[t]
                seed_scores = tanimoto_rows_to_target(
                    self.fps[self.top], self.pops[self.top], target, t_pop)
            else:
                seed_scores = self.table[self.top]
            st = tdev.prime(st, self.dg, self.top.to(torch.int32),
                            seed_scores)
        t0 = time.perf_counter()
        with span("campaign.run"):
            if self.scorer == "tanimoto":
                st = tdev.fused_run(st, self.dg, self.fps, self.pops, target,
                                    t_pop, self.budget, batch=self.batch)
            else:
                st = self.run_table(st, self.budget)
            n_scored = int(st.n_scored)
        run_s = time.perf_counter() - t0
        with span("campaign.read"):
            order = st.order_log[:n_scored]
            scores = st.scores[order.long()]
            res = dict(campaign=c, order=order.cpu().numpy(),
                       scores=scores.cpu().numpy(),
                       dropped=int(st.n_dropped), steps=int(st.n_steps),
                       run_s=run_s)
        self.state = st
        if keep:
            self.results.append(res)
        return res

    def window(self, seconds, tracer, control=False):
        self.results = []
        unit = ((lambda i: self._reference_campaign(i, torch.bfloat16,
                                                    keep=True))
                if control else
                (lambda i: self._campaign(i, keep=True, tracer=tracer)))
        units, wall, unit_s = closed_loop(seconds, self.device, tracer,
                                          unit)
        self.state = None
        return {
            "units": units,
            "wall_s": wall,
            "unit_s": unit_s,
            "device_scored": sum(len(r["order"]) for r in self.results),
            "run_s": sum(r["run_s"] for r in self.results),
            "steps": sum(r["steps"] for r in self.results),
        }

    def release(self):
        self.state = None
        self.dg = None
        self.run_table = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ----------------------------------------------------------
    def _score_fn(self, c: int, sim_dtype):
        if self.scorer == "tanimoto":
            t = int(self.targets[c])
            target, t_pop = self.fps[t], int(self.pops[t])

            def score(ids):
                ok = ids >= 0
                safe = torch.where(ok, ids, 0)
                return distance_to_target(
                    self.fps[safe], self.pops[safe], target, t_pop,
                    sim_dtype).masked_fill(~ok, INF)
        else:
            table = self.table
            if sim_dtype != torch.float32:
                table = table.to(sim_dtype).to(torch.float32)

            def score(ids):
                ok = ids >= 0
                return table[torch.where(ok, ids, 0)].masked_fill(~ok, INF)
        return score

    def _reference_campaign(self, c: int, sim_dtype, keep: bool = False):
        g = ref.Graph(self.adj, self.offsets, self.n)
        camp = ref.Campaign(g, **self.caps)
        score = self._score_fn(c, sim_dtype)
        t0 = time.perf_counter()
        camp.prime(self.top, score(self.top))
        camp.run(self.batch, score, self.budget)
        order = camp.order()
        res = dict(campaign=c, order=order.astype(np.int32),
                   scores=camp.scores_of(order), dropped=camp.n_dropped,
                   steps=camp.n_steps, run_s=time.perf_counter() - t0)
        if keep:
            self.results.append(res)
        return res

    def check(self):
        rng = np.random.default_rng(sub_seed(self.seed, 4))
        k = min(int(self.tr["check_campaigns"]), len(self.results))
        # the campaign that took the most steps, and others drawn from
        # the seed
        longest = max(range(len(self.results)),
                      key=lambda i: self.results[i]["steps"])
        rest = [i for i in range(len(self.results)) if i != longest]
        picked = [longest] + list(rng.choice(rest, size=k - 1,
                                             replace=False)) if k > 1 \
            else [longest]
        totals = dict(order_mismatch=0, score_mismatch=0, dropped_diff=0,
                      steps_diff=0)
        self.failed = 0
        for i in picked:
            got = self.results[int(i)]
            want = self._reference_campaign(got["campaign"], torch.float32)
            diff = dict(
                order_mismatch=mismatches(got["order"], want["order"]),
                score_mismatch=mismatches(got["scores"], want["scores"]),
                dropped_diff=abs(got["dropped"] - want["dropped"]),
                steps_diff=abs(got["steps"] - want["steps"]))
            for key, v in diff.items():
                totals[key] += v
            self.failed += int(any(diff.values()))
        return [{"name": k, "value": v, "limit": 0}
                for k, v in totals.items()]
