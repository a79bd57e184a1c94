#!/usr/bin/env python3
"""Smoke run of rad_tpu_torch on one CUDA card.

    python3 chip_smoke.py            # all phases; needs one CUDA device

Phases, one status line each (plus detail lines):

1. device: ``nvidia-smi`` name and power limit, torch/CUDA versions, and
   the kernels built by nvcc for sm_90a from ``rad_tpu_torch/csrc``;
2. each CUDA kernel against its plain-torch twin on the card, at the main
   path's shapes (1024-bit fingerprints): array-equal, and both timed with
   CUDA events;
3. a 16,384-row library built with ``build_hnsw_exact`` on the card and on
   the CPU (twins): edge-identical on every layer; then the same traversal
   on both: identical scoring order;
4. the main path at 1,000,000 molecules x 1024 bits, M = 16, through the
   user entry points: ``HNSWIndex.add/build`` → ``save``/``load`` →
   ``create_local_traverser`` → ``prime`` → ``traverse(10_000)`` →
   ``get_best_molecules(100)``, with launch counters proving both kernels
   ran, and the result checked (no duplicate ids, top-100 recovery at
   least 5x random).

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
from rad_tpu_torch.store import InMemorySmilesStore
from rad_tpu_torch.synthetic import make_library
from rad_tpu_torch.traverse.driver import DeviceTraverser

KERNELS = {
    "tanimoto_bucketmin": dict(
        wrapper=kernels.tanimoto_bucketmin,
        replaces="rad_tpu/fp/kernels.py:209"),
    "tanimoto_matrix": dict(
        wrapper=kernels.tanimoto_matrix,
        replaces="rad_tpu/fp/kernels.py:101"),
}
SOURCE = "rad_tpu_torch/csrc/tanimoto.cu"
N = 1_000_000            # main-path library: molecules x 1024 bits
N_TO_SCORE = N // 100    # main-path budget: 1% scored


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

    for k in KERNELS.values():
        k["wrapper"].launches = 0
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
        launches = {name: k["wrapper"].launches
                    for name, k in KERNELS.items()}

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
        launches = phase_main_path(dev, N, N_TO_SCORE)
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCE,
             replaces=k["replaces"], launches=launches[name],
             **timings[name])
        for name, k in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
