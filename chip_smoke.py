#!/usr/bin/env python3
"""Smoke run of rad_tpu_torch on one CUDA card.

    python3 chip_smoke.py            # all phases; needs one CUDA device

Phases, one status line each (plus detail lines):

1. device: ``nvidia-smi`` name and power limit, torch/CUDA versions, and
   the kernels built by nvcc for sm_90a from ``rad_tpu_torch/csrc``;
2. each CUDA kernel against its plain-torch twin on the card, at the
   shapes its path gives it (1024-bit fingerprints; 2,048 candidates over
   the 1M graph's 1,000,000 ids and 1,066,610 rows): array-equal, and both
   timed with CUDA events;
3. a 16,384-row library built with ``build_hnsw_exact`` on the card and on
   the CPU (twins): edge-identical on every layer; then the same traversal
   on both: identical scoring order;
4. the main path at 1,000,000 molecules x 1024 bits, M = 16, through the
   user entry points: ``HNSWIndex.add/build`` → ``save``/``load`` →
   ``create_local_traverser`` → ``prime`` → ``traverse(10_000)`` →
   ``get_best_molecules(100)``, with launch counters proving both kernels
   ran, and the result checked (no duplicate ids, top-100 recovery at
   least 5x random);
5. the device-scored traversal on phase 4's graph, full width and depth:
   (a) ``prime`` + ``fused_run(batch=64, n_to_score=100_000)`` with the
   Tanimoto-to-target scorer, once through the fused candidate kernels
   K1/K2 and once through the plain chain: identical states; (b) the same
   pair with ``narrow_width=1024``, where K2 sees fewer to-score ids than
   candidates; (c) ``make_device_run`` with a score-table scorer at batch
   8: the same scoring order as phase 4's host-scored traversal.

The last three lines are the card's ``nvidia-smi`` line, a JSON object
describing each kernel, and ``{"ok": true, "device": {...}}``. Any failed
check exits non-zero before those lines; so does a machine without CUDA.
The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from rad_tpu_torch import HNSWIndex, _cuda, create_local_traverser
from rad_tpu_torch.build.exact import build_hnsw_exact
from rad_tpu_torch.fp import kernels
from rad_tpu_torch.fp.pack import (popcount_rows, random_fingerprints,
                                   to_torch_packed)
from rad_tpu_torch.fp.tanimoto import tanimoto_rows_to_target
from rad_tpu_torch.store import InMemorySmilesStore
from rad_tpu_torch.synthetic import make_library
from rad_tpu_torch.traverse import candidate_ops
from rad_tpu_torch.traverse import device as tdev
from rad_tpu_torch.traverse.driver import DeviceTraverser

KERNELS = {
    "tanimoto_bucketmin": dict(
        wrapper=kernels.tanimoto_bucketmin,
        source="rad_tpu_torch/csrc/tanimoto.cu",
        replaces="rad_tpu/fp/kernels.py:209"),
    "tanimoto_matrix": dict(
        wrapper=kernels.tanimoto_matrix,
        source="rad_tpu_torch/csrc/tanimoto.cu",
        replaces="rad_tpu/fp/kernels.py:101"),
    "candidate_filter": dict(
        wrapper=candidate_ops.candidate_filter,
        source="rad_tpu_torch/csrc/candidates.cu",
        replaces="rad_tpu/traverse/pallas_ops.py:49"),
    "integrate_candidates": dict(
        wrapper=candidate_ops.integrate_candidates,
        source="rad_tpu_torch/csrc/candidates.cu",
        replaces="rad_tpu/traverse/pallas_ops.py:102"),
}
N = 1_000_000            # main-path library: molecules x 1024 bits
N_TO_SCORE = N // 100    # main-path budget: 1% scored
R = 1_066_610            # the 1M graph's (node, level) rows
K = 64 * 32              # candidates per device-scored step: batch x M0
TARGET = 17              # phase 5's target: one library row


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    smi = nvidia_smi_line()
    print(f"[1 device] {smi} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    _cuda.load_library()
    info = _cuda.build_info()
    print(f"[1 build] nvcc {info['flags']} {' '.join(info['sources'])} "
          f"-> {os.path.basename(info['path'])} "
          f"(compiled here: {info['built']}, {info['seconds']:.2f} s)",
          flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"    ptxas: {line.strip()}")
    return smi


def _turns(kernel_fn, plain_fn):
    """plain, kernel, kernel, plain — then the mean of each pair."""
    p1 = time_ms(plain_fn)
    k1 = time_ms(kernel_fn)
    k2 = time_ms(kernel_fn)
    p2 = time_ms(plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_kernels(dev) -> dict:
    results = {}
    q = to_torch_packed(random_fingerprints(4096, 1024, 0.12, seed=1), dev)
    db = to_torch_packed(random_fingerprints(8192, 1024, 0.12, seed=2), dev)
    qp, dp = popcount_rows(q), popcount_rows(db)
    keys = kernels.tanimoto_bucketmin(q, db, 64, qp, dp)
    torch.cuda.synchronize()
    plain = kernels.tanimoto_bucketmin_plain(q, db, 64, qp, dp)
    err = int((keys.long() - plain.long()).abs().max())
    check(keys.shape == (4096, 128) and torch.equal(keys, plain),
          f"tanimoto_bucketmin != plain (max key diff {err})")
    ms, plain_ms = _turns(
        lambda: kernels.tanimoto_bucketmin(q, db, 64, qp, dp),
        lambda: kernels.tanimoto_bucketmin_plain(q, db, 64, qp, dp))
    results["tanimoto_bucketmin"] = dict(max_abs_err=float(err), ms=ms,
                                         plain_ms=plain_ms)
    print(f"[2 kernels] tanimoto_bucketmin 4096x8192 bucket 64: array-equal "
          f"to plain; {ms:.3f} ms vs plain {plain_ms:.3f} ms", flush=True)

    q = to_torch_packed(random_fingerprints(8192, 1024, 0.12, seed=3), dev)
    db = to_torch_packed(random_fingerprints(8192, 1024, 0.12, seed=4), dev)
    qp, dp = popcount_rows(q), popcount_rows(db)
    out = kernels.tanimoto_matrix(q, db, qp, dp)
    torch.cuda.synchronize()
    plain = kernels.tanimoto_matrix_plain(q, db, qp, dp)
    err = float((out - plain).abs().max())
    check(bool(torch.isfinite(out).all()) and torch.equal(out, plain),
          f"tanimoto_matrix != plain (max abs err {err})")
    ms, plain_ms = _turns(
        lambda: kernels.tanimoto_matrix(q, db, qp, dp),
        lambda: kernels.tanimoto_matrix_plain(q, db, qp, dp))
    results["tanimoto_matrix"] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms)
    print(f"[2 kernels] tanimoto_matrix 8192x8192: array-equal to plain; "
          f"{ms:.3f} ms vs plain {plain_ms:.3f} ms", flush=True)
    results.update(_candidate_kernels(dev))
    return results


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if torch.equal(a, b):
        return 0.0
    d = (a.double() - b.double()).abs().nan_to_num(nan=float("inf"))
    return float(d.max())


def _candidate_case(rng, n: int, k: int, n_rows: int):
    """The recipe of tests/test_pallas_ops.py make_case: ~20 % invalid
    candidates, half of the second half copied from the first (duplicates),
    about half the ids scored, 40 % of the rows enqueued."""
    cand = rng.integers(-1, n, size=k).astype(np.int32)
    cand[rng.random(k) < 0.2] = -1
    cand[k // 2:] = np.where(rng.random(k - k // 2) < 0.5,
                             cand[: k - k // 2], cand[k // 2:])
    scored = rng.random(n) < 0.5
    scores = np.where(scored, rng.random(n), np.inf).astype(np.float32)
    enqueued = rng.random(n_rows) < 0.4
    row = np.minimum(np.maximum(cand, 0) + rng.integers(0, 3, size=k),
                     n_rows - 1).astype(np.int32)
    return cand, scored, scores, enqueued, row


def _candidate_kernels(dev) -> dict:
    rng = np.random.default_rng(5)
    cand, scored, scores, enqueued, row = [
        torch.from_numpy(a).to(dev)
        for a in _candidate_case(rng, N, K, R)]
    ts = candidate_ops.candidate_filter(cand, scored)
    torch.cuda.synchronize()
    plain_ts = candidate_ops.candidate_filter_plain(cand, scored)
    err = _max_abs_err(ts, plain_ts)
    check(err == 0.0 and int((ts >= 0).sum()) > 0,
          f"candidate_filter != plain (max abs err {err})")
    ms, plain_ms = _turns(
        lambda: candidate_ops.candidate_filter(cand, scored),
        lambda: candidate_ops.candidate_filter_plain(cand, scored))
    results = {"candidate_filter": dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain_ms)}
    print(f"[2 kernels] candidate_filter K={K} over N={N:,}: array-equal to "
          f"plain ({int((ts >= 0).sum())} ids); {ms:.4f} ms vs plain "
          f"{plain_ms:.4f} ms", flush=True)

    new_scores = torch.rand(K, device=dev)
    errs = {}
    for kt in (K, K // 2):          # full width, and narrow_width's prefix
        tables = [t.clone() for t in (scored, scores, enqueued)]
        plain_tables = [t.clone() for t in (scored, scores, enqueued)]
        got = candidate_ops.integrate_candidates(
            ts[:kt], new_scores[:kt], cand, row, *tables)
        torch.cuda.synchronize()
        want = candidate_ops.integrate_candidates_plain(
            ts[:kt], new_scores[:kt], cand, row, *plain_tables)
        for name, g, w in zip(["scored", "scores", "enqueued", "fresh",
                               "push", "cand_score"], got, want):
            errs[f"{name}@{kt}"] = _max_abs_err(g, w)
        check(bool(got[3].any()) and bool(got[4].any()),
              "integrate_candidates case has no fresh id or no push")
    err = max(errs.values())
    check(err == 0.0, f"integrate_candidates != plain: {errs}")
    # every timed call gets its own copy of the tables, as a step would
    # find them (each of _turns' four windows makes 2 + 10 calls)
    copies = iter([[t.clone() for t in (scored, scores, enqueued)]
                   for _ in range(48)])
    ms, plain_ms = _turns(
        lambda: candidate_ops.integrate_candidates(
            ts, new_scores, cand, row, *next(copies)),
        lambda: candidate_ops.integrate_candidates_plain(
            ts, new_scores, cand, row, *next(copies)))
    results["integrate_candidates"] = dict(max_abs_err=err, ms=ms,
                                           plain_ms=plain_ms)
    print(f"[2 kernels] integrate_candidates kt=kc={K} (and kt={K // 2}), "
          f"N={N:,}, R={R:,}: every output and table array-equal to plain; "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms", flush=True)
    return results


def phase_build_parity(dev) -> None:
    packed, scores = make_library(16384, seed=7)
    t0 = time.perf_counter()
    g_cuda = build_hnsw_exact(packed, connectivity=16, seed=0, device=dev)
    t1 = time.perf_counter()
    g_cpu = build_hnsw_exact(packed, connectivity=16, seed=0, device="cpu")
    t2 = time.perf_counter()
    check(g_cuda.layer_sizes == g_cpu.layer_sizes, "layer sizes differ")
    check(np.array_equal(g_cuda.keys, g_cpu.keys), "keys differ")
    for l, (a, b) in enumerate(zip(g_cuda.neighbors, g_cpu.neighbors)):
        diff = int((a != b).sum())
        check(diff == 0, f"layer {l}: {diff} neighbor slots differ")
    print(f"[3 build parity] 16,384 rows, layers {g_cuda.layer_sizes}: CUDA "
          f"build edge-identical to the CPU build ({t1 - t0:.2f} s vs "
          f"{t2 - t1:.2f} s)", flush=True)

    def score(smiles: str) -> float:
        return float(scores[int(smiles)])

    orders = []
    for device in (dev, "cpu"):
        t = DeviceTraverser(g_cuda, score, batch_size=8, n_score_threads=1,
                            device=device)
        t.prime()
        t.traverse(n_to_score=2000)
        orders.append(t.get_molecules())
        t.shutdown()
    check(orders[0] == orders[1], "CUDA and CPU traversal orders differ")
    print(f"[3 traverse parity] {len(orders[0])} molecules scored in the "
          f"same order on CUDA and CPU", flush=True)


def _check_graph(g) -> None:
    for l, t in enumerate(g.neighbors):
        t = np.asarray(t)
        n_l = g.layer_sizes[l]
        check(t.shape == (n_l, 2 * g.connectivity if l == 0
                          else g.connectivity), f"layer {l} shape {t.shape}")
        check(int(t.min()) >= -1 and int(t.max()) < n_l,
              f"layer {l}: ids out of range")
        check(not (t == np.arange(n_l)[:, None]).any(),
              f"layer {l}: self loop")
        if n_l > 1:
            check(bool((t[:, 0] >= 0).all()), f"layer {l}: isolated node")


def phase_main_path(dev, n: int, n_to_score: int) -> dict:
    t0 = time.perf_counter()
    packed, true_scores = make_library(n, seed=0)
    store = InMemorySmilesStore({i: f"MOL_{i}" for i in range(n)})
    t_lib = time.perf_counter() - t0

    def scoring_fn(smiles: str) -> float:
        return float(true_scores[int(smiles[4:])])

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = HNSWIndex(ndim=1024, connectivity=16, device=dev)
    index.add(np.arange(n), packed)
    stage = {}
    index.build(stage_times=stage)
    t_build = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "library.rad.npz")
        t0 = time.perf_counter()
        index.save(path)
        loaded = HNSWIndex.load(path, device=dev)
        _check_graph(loaded.graph)
        t_io = time.perf_counter() - t0
        traverser = create_local_traverser(loaded, scoring_fn,
                                           smiles_store=store, batch_size=8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traverser.prime()
        stats = traverser.traverse(n_to_score=n_to_score)
        best = traverser.get_best_molecules(100)
        t_trav = time.perf_counter() - t0
        mols = traverser.get_molecules()
        dev_stats = traverser.get_traversal_stats()["device"]
        traverser.shutdown()
        launches = {name: KERNELS[name]["wrapper"].launches
                    for name in ("tanimoto_bucketmin", "tanimoto_matrix")}
        graph = loaded.graph
        context = dict(
            dg=tdev.prepare_device_graph(graph, dev),
            packed=to_torch_packed(np.asarray(graph.packed), dev),
            pops=torch.from_numpy(np.asarray(graph.popcounts)
                                  .astype(np.int32)).to(dev),
            keys=np.asarray(graph.keys), true_scores=true_scores,
            n_top=graph.layer_sizes[graph.max_level], mols=mols)

    for name, count in launches.items():
        check(count > 0, f"{name} never launched on the main path")
    n_scored = stats["n_scored"]
    check(n_scored >= n_to_score, f"n_scored {n_scored} < {n_to_score}")
    ids = np.array([m[0] for m in mols])
    check(len(np.unique(ids)) == len(ids), "duplicate ids in the order log")
    check(bool(((ids >= 0) & (ids < n)).all()), "order-log id out of range")
    keys = np.asarray(loaded.graph.keys)
    check(len(best) == 100 and all(
        np.isfinite(s) and s == np.float32(true_scores[keys[i]])
        for i, s, _ in best), "best molecules carry wrong scores")
    true_top = set(np.argsort(true_scores, kind="stable")[:100].tolist())
    found = len(true_top & set(keys[ids].tolist()))
    random_expect = 100 * n_scored / n
    check(found >= 5 * random_expect,
          f"top-100 recovery {found} < 5 x random ({random_expect:.2f})")
    layer_sizes = loaded.graph.layer_sizes
    print(f"[4 main path] {n:,} x 1024-bit, M=16, layers {layer_sizes}: "
          f"library {t_lib:.1f} s; build {t_build:.2f} s (candidates "
          f"{stage['candidates']:.2f} s, selection {stage['selection']:.2f}"
          f" s, symmetrization {stage['symmetrization']:.2f} s); save+load "
          f"{t_io:.2f} s", flush=True)
    print(f"[4 main path] prime+traverse+best: {t_trav:.2f} s, {n_scored:,} "
          f"scored ({n_scored / t_trav:,.0f} scored/s, {dev_stats['steps']} "
          f"steps, host scoring {dev_stats['scoring_time']:.2f} s, device "
          f"calls {dev_stats['device_time']:.2f} s, frontier dropped "
          f"{dev_stats['frontier_dropped']}); "
          f"top-100 found {found} ({found / max(random_expect, 1e-9):.1f}x "
          f"random); launches {launches}", flush=True)
    return launches, context


def _reset_counts() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0
    candidate_ops.integrate_candidates.narrow_launches = 0


def _states_equal(a, b) -> bool:
    ra, rb = (tdev.state_to_reference_arrays(s) for s in (a, b))
    return all(np.array_equal(ra[k], rb[k]) for k in ra)


def phase_device_scored(dev, ctx: dict) -> dict:
    dg, packed, pops, n_top = ctx["dg"], ctx["packed"], ctx["pops"], \
        ctx["n_top"]
    target, tpop = packed[TARGET], pops[TARGET]
    seeds = torch.arange(n_top, dtype=torch.int32, device=dev)
    seed_scores = tanimoto_rows_to_target(packed[:n_top], pops[:n_top],
                                          target, tpop)
    n_to_score = 100_000

    def run(fused: bool, narrow):
        st = tdev.prime(tdev.init_state(dg), dg, seeds, seed_scores)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = tdev.fused_run(st, dg, packed, pops, target, tpop, n_to_score,
                            batch=64, narrow_width=narrow,
                            fused_candidates=fused)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = int(st.n_scored)
        print(f"[5{'b' if narrow else 'a'} device-scored] fused_run batch "
              f"64 narrow_width={narrow} fused_candidates={fused}: {n:,} "
              f"scored in {int(st.n_steps)} steps, {dt:.2f} s "
              f"({n / dt:,.0f} scored/s, {dt / int(st.n_steps) * 1e3:.3f} "
              f"ms/step)", flush=True)
        return st

    _reset_counts()
    on = run(True, None)
    off = run(False, None)
    narrow_before = candidate_ops.integrate_candidates.narrow_launches
    on_n = run(True, 1024)
    off_n = run(False, 1024)
    launches = {name: KERNELS[name]["wrapper"].launches
                for name in ("candidate_filter", "integrate_candidates")}
    narrow = candidate_ops.integrate_candidates.narrow_launches \
        - narrow_before
    for name, count in launches.items():
        check(count > 0, f"{name} never launched on the device-scored path")
    check(narrow > 0, "integrate_candidates never ran with kt < kc in 5b")
    check(_states_equal(on, off), "5a: states differ with K1/K2 on and off")
    check(_states_equal(on_n, off_n),
          "5b: states differ with K1/K2 on and off")
    check(_states_equal(on, on_n), "narrow_width changed the state")
    log = tdev.read_order_log(on)
    check(len(log) >= n_to_score and len(np.unique(log)) == len(log),
          "5a: order log short or with duplicates")
    # the recorded scores are the Tanimoto distances to the target
    sample = torch.from_numpy(log[:: max(1, len(log) // 4096)]).to(dev)
    sample = sample.long()
    want = kernels.tanimoto_matrix_plain(target[None, :], packed[sample],
                                         tpop.reshape(1), pops[sample])[0]
    got = on.scores[sample]
    check(torch.equal(got, want), "5a: recorded scores are not the "
          f"Tanimoto distances (max err {_max_abs_err(got, want)})")
    print(f"[5 device-scored] states identical with K1/K2 on and off, full "
          f"and narrow (K2 narrow launches {narrow}); launches {launches}; "
          f"{sample.numel()} recorded scores equal the Tanimoto distances",
          flush=True)

    # 5c: a score-table scorer against phase 4's host-scored order
    table = torch.from_numpy(np.asarray(ctx["true_scores"], np.float64)
                             [ctx["keys"]].astype(np.float32)).to(dev)
    dummy = torch.zeros((dg.n_nodes, 1), dtype=torch.uint8, device=dev)
    device_run = tdev.make_device_run(dg, dummy, table, lambda _r, t: t,
                                      batch=8)
    st = tdev.prime(tdev.init_state(dg), dg, seeds, table[:n_top])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = device_run(st, N_TO_SCORE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    host_ids = [m[0] for m in ctx["mols"]]
    got_ids = tdev.read_order_log(st).tolist()
    check(got_ids == host_ids, f"5c: device-scored order ({len(got_ids)}) "
          f"differs from the host-scored order ({len(host_ids)})")
    check(np.array_equal(tdev.gather_scores(st, got_ids),
                         np.asarray([m[1] for m in ctx["mols"]],
                                    np.float32)),
          "5c: device-scored scores differ from the host-scored ones")
    print(f"[5c device-scored] make_device_run, table scorer, batch 8: "
          f"{len(got_ids):,} scored in {int(st.n_steps)} steps, {dt:.2f} s "
          f"({len(got_ids) / dt:,.0f} scored/s); order and scores identical "
          f"to phase 4's host-scored traversal", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    try:
        smi = phase_device()
        timings = phase_kernels(dev)
        phase_build_parity(dev)
        launches, context = phase_main_path(dev, N, N_TO_SCORE)
        launches.update(phase_device_scored(dev, context))
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=k["source"],
             replaces=k["replaces"], launches=launches[name],
             **timings[name])
        for name, k in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
