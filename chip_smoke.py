#!/usr/bin/env python3
"""Smoke run of rad_tpu_torch on one CUDA card.

    python3 chip_smoke.py            # all phases; needs one CUDA device

Phases, one status line each (plus detail lines):

1. device: ``nvidia-smi`` name and power limit, torch/CUDA versions, and
   the kernels built by nvcc for sm_90a from ``rad_tpu_torch/csrc``;
2. each CUDA kernel against its plain-torch twin on the card, at the
   shapes its path gives it (1024-bit fingerprints; 2,048 candidates over
   the 1M graph's 1,000,000 ids and 1,066,610 rows): array-equal (the
   bucket kernel's approximate-reciprocal epilogue: decoded distances
   within 2^-14 and chosen entries' true distances within 1e-6), both
   timed with CUDA events, beside the kernel's bound on the card (the
   larger of its int8 tensor-core operations over 1,979 TOP/s and its
   bytes over 3.35 TB/s) and, for the Tanimoto kernels, one bf16
   ``torch.mm`` of the unpacked bits (the intersections alone);
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
   8: the same scoring order as phase 4's host-scored traversal;
6. the cluster-probed build at 10,000,000 molecules x 1024 bits, M = 16
   (the library and operating point of
   ``benchmarks/bench_probe_sweep.py``'s qblock:16 point): (a) the library;
   (b) ``HNSWIndex.build(probes=16, probe_csize=8192, probe_sample=16,
   probe_granularity="qblock", probe_min_n=0)`` with both Tanimoto kernels
   launched and layer 0 probed; (c) edge recall@10 and ``index.search``
   recall@10 at ef 32 and 128 over 500 member queries against brute force,
   each within its bound of the reference's recorded value; (d) ``prime``
   + ``make_device_run`` with the score table at batch 512, K1/K2 on, to
   1 % scored: at least half the true top-1000 found; (e) phase 4's 1M
   build again with ``bucket_approx=True``: at least 99 % of layer-0 slots
   equal; (f) a 32,768-row probed build on the card and on the CPU, both
   granularities: edge-identical;
7. the 1-NN sweep of the repo's benchmark problem, 2048 queries x
   1,048,576 rows x 1024 bits (``random_fingerprints``, density 0.1,
   seed 0; the queries drawn with seed 1, not from the library): (a) ``tanimoto_nn`` array-equal to its twin and to the
   ``matmul`` path's minima; (b) the fast epilogue at n_tile 2048 and
   1024: decoded distances within 2^-12 of the twin's, chosen ids' true
   distances within 2^-12 of the exact minima; (c) the floor, unpack and
   epilogue probes at q_tile 512, n_tile 1024 array-equal to their twins
   (newton within 1e-6); each kernel timed against its twin; then the
   entry points with launch counters: (d) ``rad_tpu_torch.bench.main``
   with its defaults, (e) ``rad_tpu_torch.bench_kernel_variants.main``
   over every kernel's variants;
8. the engine variants at full width on phase 4's graph: (a)
   ``rad_tpu_torch.bench_scalar_probe.main`` with its defaults (the three
   scalar-loop probes at 8,192 candidates over 2^20 rows, with launch
   counters); (b) the receptor-panel sweep ``fused_run_multi_tables`` with
   43 score tables (the recipe of ``examples/panel_screening.py``), 1 %
   scored per campaign at batch 8: campaigns 0, 21 and 42 equal to solo
   ``make_device_run`` runs (scored set, scores, order, drops), again
   with unequal budgets so campaigns freeze; aggregate scored/s, ms,
   launches and synchronisations per step at 1, 8 and 43 campaigns; (c)
   ``fused_run_multi`` with 8 Tanimoto targets at batch 64, campaign 0
   equal to 5a's solo run; (d) ``RADTraverser(order_log_spill=<file>)``
   with a 1,024-id device ring: the spilled order equals phase 4's; (e)
   ``make_device_run`` over the bit-packed adjacency (20-bit fields): the
   order of 5c.

Phase 2 also holds the three probes to their twins (8,192 candidates over
2^20 rows: the benchmark's inputs, a case of repeated ids, a case with
every bit set).

The last three lines are the card's ``nvidia-smi`` line, a JSON object
describing each kernel, and ``{"ok": true, "device": {...}}``. Any failed
check exits non-zero before those lines; so does a machine without CUDA.
The script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from rad_tpu_torch import (HNSWIndex, _cuda, bench, bench_kernel_variants,
                           bench_scalar_probe, create_local_traverser,
                           profiling)
from rad_tpu_torch.build.exact import build_hnsw_exact
from rad_tpu_torch.fp import kernels
from rad_tpu_torch.fp.pack import (popcount_rows, random_fingerprints,
                                   to_torch_packed)
from rad_tpu_torch.fp.tanimoto import (tanimoto_distance,
                                       tanimoto_rows_to_target)
from rad_tpu_torch.store import InMemorySmilesStore
from rad_tpu_torch.synthetic import make_library, make_receptor_tables
from rad_tpu_torch.traverse import candidate_ops
from rad_tpu_torch.traverse import device as tdev
from rad_tpu_torch.traverse import multi
from rad_tpu_torch.traverse.driver import DeviceTraverser

# name -> wrapper, the wrapper attribute that counts its launches, source
KERNELS = {
    "tanimoto_bucketmin": dict(
        wrapper=kernels.tanimoto_bucketmin,
        source="rad_tpu_torch/csrc/tanimoto.cu",
        replaces="rad_tpu/fp/kernels.py:209"),
    "tanimoto_bucketmin_approx": dict(
        wrapper=kernels.tanimoto_bucketmin, counter="approx_launches",
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
    "tanimoto_nn": dict(
        wrapper=kernels.tanimoto_nn,
        source="rad_tpu_torch/csrc/tanimoto.cu",
        replaces="rad_tpu/fp/kernels.py:354"),
    "tanimoto_nn_approx": dict(
        wrapper=kernels.tanimoto_nn, counter="approx_launches",
        source="rad_tpu_torch/csrc/tanimoto.cu",
        replaces="rad_tpu/fp/kernels.py:354"),
    "nn_floor": dict(
        wrapper=kernels.nn_floor,
        source="rad_tpu_torch/csrc/tanimoto.cu",
        replaces="benchmarks/bench_kernel_variants.py:40"),
    "nn_epilogue_probe": dict(
        wrapper=kernels.nn_epilogue_probe,
        source="rad_tpu_torch/csrc/tanimoto.cu",
        replaces="benchmarks/bench_kernel_variants.py:134"),
    "scalar_gather": dict(
        wrapper=candidate_ops.scalar_gather,
        source="rad_tpu_torch/csrc/scalar_probe.cu",
        replaces="benchmarks/bench_scalar_probe.py:118"),
    "scalar_checkset": dict(
        wrapper=candidate_ops.scalar_checkset,
        source="rad_tpu_torch/csrc/scalar_probe.cu",
        replaces="benchmarks/bench_scalar_probe.py:125"),
    "scalar_chain": dict(
        wrapper=candidate_ops.scalar_chain,
        source="rad_tpu_torch/csrc/scalar_probe.cu",
        replaces="benchmarks/bench_scalar_probe.py:133"),
}
N = 1_000_000            # main-path library: molecules x 1024 bits
N_TO_SCORE = N // 100    # main-path budget: 1% scored
R = 1_066_610            # the 1M graph's (node, level) rows
K = 64 * 32              # candidates per device-scored step: batch x M0
TARGET = 17              # phase 5's target: one library row
N10 = 10_000_000         # phase 6's library
# phase 6c: the reference's recorded qblock:16 graph properties on this
# library (BENCHMARKS.md:450, 457, 466) and the bound each is held to.
# They are one partition's. A one-ulp change to the bisection scores gives
# another partition (tests/test_torch_probe.py), and over four partitions
# of this library edge recall spread with SD 0.010 (PERF.md, section 6),
# so its bound is 3 SD; the reference's own 0.01 is reported beside it
REF_RECALL = {"edge": (0.558, 0.03), "ef32": (0.7064, 0.03),
              "ef128": (0.9000, 0.03)}
EDGE_REF_TOL = 0.01
NQ, NN = 2048, 1 << 20   # phase 7: the repo's benchmark problem
PROBE_K, PROBE_N = 8192, 1 << 20   # the scalar-loop probes' problem
PANEL_T = 43             # phase 8b: a DUDE-Z sized receptor panel
PANEL_CHECKED = (0, PANEL_T // 2, PANEL_T - 1)
# published peaks of one H100 SXM (NVIDIA's data sheet): dense int8
# tensor-core operations and HBM3 bytes per second
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


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


def _turns(kernel_fn, plain_fn, iters: int = 10, warmup: int = 2):
    """plain, kernel, kernel, plain — then the mean of each pair."""
    p1 = time_ms(plain_fn, iters, warmup)
    k1 = time_ms(kernel_fn, iters, warmup)
    k2 = time_ms(kernel_fn, iters, warmup)
    p2 = time_ms(plain_fn, iters, warmup)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take: operations over the int8 peak
    or bytes over the memory rate, whichever is larger."""
    t_ops = ops / PEAK_INT8_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _tanimoto_bound(nq: int, nn: int, w: int, out_bytes: int) -> dict:
    """2*Q*N*D int8 operations; packed rows and popcounts read once, the
    output written once."""
    return _bound(2.0 * nq * nn * 32 * w, (nq + nn) * (4 * w + 4)
                  + out_bytes)


def _library_ms(q, db, iters: int = 10) -> float:
    """One bf16 ``torch.mm`` of the unpacked bits with f32 sums: the
    intersections the Tanimoto kernels share, as a library computes
    them."""
    qb, dbb = bench.unpack_to_dtype(q), bench.unpack_to_dtype(db)
    return time_ms(lambda: bench.intersections_bf16(qb, dbb), iters,
                   warmup=1)


def _fmt(r: dict, library: str = "bf16 torch.mm") -> str:
    lib = r.get("library_ms")
    return (f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms; bound "
            f"{r['bound_ms']:.4g} ms by {r['bound_by']}"
            + (f"; {library} {lib:.4f} ms" if lib is not None else ""))


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
    lib_ms = _library_ms(q, db)
    bound = _tanimoto_bound(4096, 8192, 32, 4096 * 128 * 4)
    results["tanimoto_bucketmin"] = r = dict(
        max_abs_err=float(err), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        **bound)
    print(f"[2 kernels] tanimoto_bucketmin 4096x8192 bucket 64: array-equal "
          f"to plain; {_fmt(r)}", flush=True)

    keys = kernels.tanimoto_bucketmin(q, db, 64, qp, dp, approx=True)
    torch.cuda.synchronize()
    plain = kernels.tanimoto_bucketmin_plain(q, db, 64, qp, dp, approx=True)
    (d, gid), (pd, pgid) = (kernels.decode_bucket_keys(k, 64)
                            for k in (keys, plain))
    err = float((d - pd).abs().max())
    true = kernels.tanimoto_matrix_plain(q, db, qp, dp)
    chosen = float((true.gather(1, gid.long())
                    - true.gather(1, pgid.long())).abs().max())
    check(err <= 2.0 ** -14 and chosen <= 1e-6,
          f"approx tanimoto_bucketmin vs plain: decoded distances differ by "
          f"{err} (bound 2^-14), chosen entries' true distances by {chosen} "
          f"(bound 1e-6)")
    ms, plain_ms = _turns(
        lambda: kernels.tanimoto_bucketmin(q, db, 64, qp, dp, approx=True),
        lambda: kernels.tanimoto_bucketmin_plain(q, db, 64, qp, dp,
                                                 approx=True))
    results["tanimoto_bucketmin_approx"] = r = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        **bound)
    print(f"[2 kernels] tanimoto_bucketmin approx=True 4096x8192 bucket 64: "
          f"decoded distances within {err:.3g} of plain (bound 2^-14), "
          f"chosen entries' true distances within {chosen:.3g} (bound "
          f"1e-6), {int((gid != pgid).sum())} of {gid.numel()} winners "
          f"differ; {_fmt(r)}", flush=True)

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
    results["tanimoto_matrix"] = r = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        library_ms=_library_ms(q, db),
        **_tanimoto_bound(8192, 8192, 32, 8192 * 8192 * 4))
    print(f"[2 kernels] tanimoto_matrix 8192x8192: array-equal to plain; "
          f"{_fmt(r)}", flush=True)
    results.update(_candidate_kernels(dev))
    results.update(_scalar_probes(dev))
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
    # K ids read, one scored byte per valid id, K ids written
    n_valid = int(((cand >= 0) & (cand < N)).sum())
    results = {"candidate_filter": dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        **_bound(0.0, 4 * K + n_valid + 4 * K))}
    print(f"[2 kernels] candidate_filter K={K} over N={N:,}: array-equal to "
          f"plain ({int((ts >= 0).sum())} ids); "
          f"{_fmt(results['candidate_filter'])}", flush=True)

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
        if kt == K:
            n_fresh, n_push = int(got[3].sum()), int(got[4].sum())
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
    # the four id/score vectors read; per valid id a scored byte read and,
    # when fresh, a score and a byte written; per candidate an enqueued
    # byte read; per push a byte written and a score read; the three
    # masks written
    n_ts = int((ts >= 0).sum())
    nbytes = (16 * K + n_ts + 5 * n_fresh + K + 5 * n_push + K + K + 4 * K)
    results["integrate_candidates"] = r = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        **_bound(0.0, nbytes))
    print(f"[2 kernels] integrate_candidates kt=kc={K} (and kt={K // 2}), "
          f"N={N:,}, R={R:,}: every output and table array-equal to plain; "
          f"{_fmt(r)}", flush=True)
    return results


def _probe_case(name: str, dev) -> dict:
    x = bench_scalar_probe.probe_inputs(PROBE_K, PROBE_N, dev)
    if name == "repeated ids":
        # every id four times over, shuffled
        perm = torch.from_numpy(
            np.random.default_rng(1).permutation(PROBE_K)).to(dev)
        x["idx"] = x["idx"][: PROBE_K // 4].repeat(4, 1)[perm].contiguous()
    elif name == "every bit set":
        x["bm"].fill_(-1)
        x["scored"].fill_(-1)
    return x


def _scalar_probes(dev) -> dict:
    """The three scalar-loop probes against their twins: counts, the
    gather sum and the emitted ids array-equal; the score sum, a float64
    sum rounded once on both sides, within one f32 ulp."""
    ops = candidate_ops
    worst = {"scalar_gather": 0.0, "scalar_checkset": 0.0,
             "scalar_chain": 0.0}
    for name in ("benchmark inputs", "repeated ids", "every bit set"):
        x = _probe_case(name, dev)
        idx, tab, bm = x["idx"], x["tab"], x["bm"]
        scored, scores = x["scored"], x["scores"]
        bm_before = bm.clone()
        gather = ops.scalar_gather(idx, tab)
        checkset = ops.scalar_checkset(idx, bm)
        out, emit, n_new, ssum = ops.scalar_chain(idx, scored, bm, scores)
        torch.cuda.synchronize()
        p_out, p_emit, p_n_new, p_ssum = ops.scalar_chain_plain(
            idx, scored, bm, scores)
        p_gather = ops.scalar_gather_plain(idx, tab)
        p_checkset = ops.scalar_checkset_plain(idx, bm)
        check(torch.equal(bm, bm_before), f"probes ({name}): bitmap modified")
        check(torch.equal(gather, p_gather),
              f"scalar_gather ({name}): {int(gather)} != {int(p_gather)}")
        check(torch.equal(checkset, p_checkset), f"scalar_checkset ({name}): "
              f"{int(checkset)} != {int(p_checkset)}")
        check(int(n_new) == int(p_n_new) and torch.equal(emit, p_emit),
              f"scalar_chain ({name}): n_new {int(n_new)} vs "
              f"{int(p_n_new)}, emit equal: {torch.equal(emit, p_emit)}")
        ulp = 2.0 ** -23 * max(float(p_ssum), 1.0)
        d_ssum = abs(float(ssum) - float(p_ssum))
        d_out = abs(float(out) - float(p_out))
        check(d_ssum <= ulp and d_out <= 2 * ulp,
              f"scalar_chain ({name}): ssum {float(ssum)} vs "
              f"{float(p_ssum)}, out {float(out)} vs {float(p_out)} (one f32 "
              f"ulp is {ulp:.3g})")
        worst["scalar_chain"] = max(worst["scalar_chain"], d_ssum, d_out)
        n_first = int(ops.scalar_checkset_plain(idx, bm))
        print(f"[2 kernels] scalar probes, {name}: gather {int(gather)}, "
              f"checkset {int(checkset)}, chain n_new {int(n_new)}, ssum "
              f"{float(ssum):.4f} (plain {float(p_ssum):.4f}, diff "
              f"{d_ssum:.3g}, one ulp {ulp:.3g}); counts and "
              f"emit[:n_new] array-equal to plain", flush=True)
        if name != "benchmark inputs":
            continue
        # bytes the card must move: idx once, one 32-byte sector per random
        # access to device memory, each bitmap copy read once, outputs once.
        # The bitmap's test-and-set goes to shared memory. Data-dependent
        # parts counted for these inputs: the scores read are those of the
        # distinct ids whose enqueue bit was clear
        k, words = PROBE_K, PROBE_N // 32
        nbytes = {
            "scalar_gather": 4 * k + 32 * k + 4,
            "scalar_checkset": 4 * k + 4 * words + 4,
            "scalar_chain": (4 * k + 4 * words + 32 * k + 32 * n_first
                             + 4 * k + 12),
        }
        fns = {
            "scalar_gather": (lambda: ops.scalar_gather(idx, tab),
                              lambda: ops.scalar_gather_plain(idx, tab)),
            "scalar_checkset": (lambda: ops.scalar_checkset(idx, bm),
                                lambda: ops.scalar_checkset_plain(idx, bm)),
            "scalar_chain": (
                lambda: ops.scalar_chain(idx, scored, bm, scores),
                lambda: ops.scalar_chain_plain(idx, scored, bm, scores)),
        }
        flat_idx, flat_tab = idx.reshape(-1).long(), tab.reshape(-1)
        results = {}
        for kernel, (kernel_fn, plain_fn) in fns.items():
            ms, plain_ms = _turns(kernel_fn, plain_fn, iters=20)
            lib = (time_ms(lambda: flat_tab[flat_idx].sum(), 20)
                   if kernel == "scalar_gather" else None)
            results[kernel] = r = dict(ms=ms, plain_ms=plain_ms,
                                       library_ms=lib,
                                       **_bound(0.0, nbytes[kernel]))
            print(f"[2 kernels] {kernel} k={k} n={PROBE_N:,}: "
                  f"{ms / k * 1e6:.3f} ns per candidate; "
                  f"{_fmt(r, 'tab[idx].sum()')} "
                  f"({nbytes[kernel]:,} bytes: far under one launch's "
                  f"latency, which is the practical floor)", flush=True)
    for kernel, r in results.items():
        r["max_abs_err"] = worst[kernel]
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
        launches = _counts("tanimoto_bucketmin", "tanimoto_matrix")
        graph = loaded.graph
        context = dict(
            dg=tdev.prepare_device_graph(graph, dev),
            packed=to_torch_packed(np.asarray(graph.packed), dev),
            pops=torch.from_numpy(np.asarray(graph.popcounts)
                                  .astype(np.int32)).to(dev),
            keys=np.asarray(graph.keys), true_scores=true_scores,
            n_top=graph.layer_sizes[graph.max_level], mols=mols,
            library=packed, graph=graph, stage=stage, index=loaded,
            scoring_fn=scoring_fn, store=store)

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
        setattr(k["wrapper"], k.get("counter", "launches"), 0)
    candidate_ops.integrate_candidates.narrow_launches = 0


def _counts(*names) -> dict:
    return {name: getattr(KERNELS[name]["wrapper"],
                          KERNELS[name].get("counter", "launches"))
            for name in names}


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
    launches = _counts("candidate_filter", "integrate_candidates")
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
    ctx["solo_5a"] = _campaign_result(on)

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


def _recall(found: np.ndarray, truth: np.ndarray) -> float:
    return float(np.mean([len(set(f.tolist()) & set(t.tolist())) / 10.0
                          for f, t in zip(found, truth)]))


def _graph_recall(index, q, qidx, truth) -> dict:
    """Edge recall@10 of the member queries' layer-0 rows and the beam
    search's recall@10 at ef 32 and 128, against ``truth`` (keys)."""
    g = index.graph
    keys = np.asarray(g.keys)
    row_of = np.empty(len(keys), np.int64)
    row_of[keys] = np.arange(len(keys))
    adj = np.asarray(g.neighbors[0])[row_of[qidx]]
    adj_keys = np.where(adj >= 0, keys[np.maximum(adj, 0)], -1)
    # a member query's own row counts as its 0-th neighbor
    got = {"edge": _recall(np.concatenate([adj_keys, qidx[:, None]], 1),
                           truth)}
    t_search = {}
    for ef in (32, 128):
        t0 = time.perf_counter()
        _, found = index.search(q, k=10, expansion_search=ef)
        t_search[ef] = time.perf_counter() - t0
        got[f"ef{ef}"] = _recall(found, truth)
    print(f"[6c recall] "
          + "; ".join(f"{name} recall@10 {got[name]:.4f} (reference "
                      f"{ref:.4f} +- {tol})"
                      for name, (ref, tol) in REF_RECALL.items())
          + f"; search {t_search[32]:.2f} s at ef 32, {t_search[128]:.2f} s "
          f"at ef 128", flush=True)
    return got


def phase_probed_10m(dev) -> dict:
    t0 = time.perf_counter()
    packed, true_scores = make_library(N10, seed=0, batch=1 << 20)
    print(f"[6a library] {N10:,} x 1024-bit (make_library, batch 2^20): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = HNSWIndex(ndim=1024, connectivity=16, device=dev)
    index.add(np.arange(N10), packed)
    stage = {}
    index.build(probes=16, probe_csize=8192, probe_sample=16,
                probe_granularity="qblock", probe_min_n=0,
                stage_times=stage)
    t_build = time.perf_counter() - t0
    launches = _counts("tanimoto_bucketmin", "tanimoto_matrix")
    g = index.graph
    probed = stage["probed_layers"]
    for name, count in launches.items():
        check(count > 0, f"{name} never launched in the 10M probed build")
    _check_graph(g)
    check(0 in probed, f"layer 0 did not probe (probed layers {probed})")
    print(f"[6b probed build] {N10:,}, M=16, probes 16 of 8192, qblock, "
          f"layers {g.layer_sizes}, probed layers {probed}: "
          f"{t_build:.1f} s (bisection {stage['bisection']:.2f} s, probe "
          f"tables {stage['probe_tables']:.2f} s, candidates "
          f"{stage['candidates']:.2f} s, selection {stage['selection']:.2f}"
          f" s, symmetrization {stage['symmetrization']:.2f} s); launches "
          f"{launches}", flush=True)

    qidx = np.random.default_rng(17).choice(N10, 500, replace=False)
    q = packed[qidx]
    t0 = time.perf_counter()
    _, truth = index.search(q, k=10, exact=True)
    t_truth = time.perf_counter() - t0
    print(f"[6c recall] 500 member queries (rng 17), brute-force truth "
          f"{t_truth:.1f} s", flush=True)
    got = _graph_recall(index, q, qidx, truth)
    edge_ref = REF_RECALL["edge"][0]
    print(f"[6c recall] edge recall@10 {got['edge']:.4f} is "
          f"{'' if abs(got['edge'] - edge_ref) <= EDGE_REF_TOL else 'not '}"
          f"within the reference's own {EDGE_REF_TOL} of {edge_ref}",
          flush=True)
    for name, (ref, tol) in REF_RECALL.items():
        check(abs(got[name] - ref) <= tol, f"10M {name} recall@10 "
              f"{got[name]:.4f} is not within {tol} of {ref}")

    keys = np.asarray(g.keys)
    dg = tdev.prepare_device_graph(g, dev)
    table = torch.from_numpy(true_scores[keys].astype(np.float32)).to(dev)
    dummy = torch.zeros((N10, 1), dtype=torch.uint8, device=dev)
    run = tdev.make_device_run(dg, dummy, table, lambda _r, t: t, batch=512,
                               fused_candidates=True)
    n_top = g.layer_sizes[g.max_level]
    st = tdev.prime(tdev.init_state(dg), dg,
                    torch.arange(n_top, dtype=torch.int32, device=dev),
                    table[:n_top])
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(st, N10 // 100)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rad_launches = _counts("candidate_filter", "integrate_candidates")
    for name, count in rad_launches.items():
        check(count > 0, f"{name} never launched in the 10M traversal")
    log = tdev.read_order_log(st)
    check(len(log) >= N10 // 100 and len(np.unique(log)) == len(log),
          "10M traversal: order log short or with duplicates")
    top = set(np.argsort(true_scores, kind="stable")[:1000].tolist())
    found = len(top & set(keys[log].tolist()))
    print(f"[6d RAD] make_device_run, score table, batch 512, K1/K2 on: "
          f"{len(log):,} scored ({100 * len(log) / N10:.2f} %) in "
          f"{int(st.n_steps)} steps, {dt:.2f} s; true top-1000 found "
          f"{found} ({found / 10:.1f} %); launches {rad_launches}",
          flush=True)
    check(found >= 500, f"10M traversal found {found} of the true top-1000 "
          f"at 1 % scored (< 50 %)")
    del index, g, dg, table, dummy, st
    return rad_launches


def phase_approx_1m(dev, ctx: dict) -> dict:
    _reset_counts()
    torch.cuda.synchronize()
    stage = {}
    g = build_hnsw_exact(ctx["library"], connectivity=16, seed=0,
                         device=dev, bucket_approx=True, stage_times=stage)
    launches = _counts("tanimoto_bucketmin_approx", "tanimoto_bucketmin")
    check(launches["tanimoto_bucketmin_approx"] > 0,
          "the approximate bucket epilogue never launched")
    check(launches["tanimoto_bucketmin"] == 0,
          "the exact bucket epilogue ran in the bucket_approx build")
    ref = np.asarray(ctx["graph"].neighbors[0])
    check(g.layer_sizes == ctx["graph"].layer_sizes, "layer sizes differ")
    same = float(np.mean(g.neighbors[0] == ref))
    print(f"[6e approx epilogue] {N:,} build with bucket_approx=True: "
          f"{100 * same:.3f} % of layer-0 slots equal phase 4's exact-"
          f"epilogue graph; candidates {stage['candidates']:.2f} s vs "
          f"exact {ctx['stage']['candidates']:.2f} s (phase 4); launches "
          f"{launches}", flush=True)
    check(same >= 0.99, f"bucket_approx build: {100 * same:.3f} % of "
          f"layer-0 slots equal the exact-epilogue graph (< 99 %)")
    # the exact epilogue's count stays phase 4's
    return {"tanimoto_bucketmin_approx": launches["tanimoto_bucketmin_approx"]}


def phase_probed_parity(dev) -> None:
    packed, _ = make_library(32768, seed=3)
    kw = dict(connectivity=16, seed=0, probes=4, probe_csize=1024,
              q_block=1024, col_block=1024, sel_block=1024, probe_min_n=0)
    for gran in ("qblock", "cluster"):
        t0 = time.perf_counter()
        stage = {}
        g_cuda = build_hnsw_exact(packed, device=dev, probe_granularity=gran,
                                  stage_times=stage, **kw)
        t1 = time.perf_counter()
        g_cpu = build_hnsw_exact(packed, device="cpu",
                                 probe_granularity=gran, **kw)
        t2 = time.perf_counter()
        check(0 in stage["probed_layers"],
              f"32k {gran}: layer 0 did not probe")
        check(g_cuda.layer_sizes == g_cpu.layer_sizes, "layer sizes differ")
        for l, (a, b) in enumerate(zip(g_cuda.neighbors, g_cpu.neighbors)):
            diff = int((a != b).sum())
            check(diff == 0, f"32k {gran} layer {l}: {diff} slots differ")
        print(f"[6f probed parity] 32,768 rows, probes 4 of 1024, {gran}, "
              f"layers {g_cuda.layer_sizes}: CUDA build edge-identical to "
              f"the CPU build ({t1 - t0:.2f} s vs {t2 - t1:.2f} s)",
              flush=True)


def _nn_checks(q, db, qp, dp) -> dict:
    """7a-7c: every 1-NN kernel against its twin at the full problem."""
    err = {}
    d, i = kernels.tanimoto_nn(q, db, q_pops=qp, db_pops=dp)
    torch.cuda.synchronize()
    pd, pi = kernels.tanimoto_nn_plain(q, db, q_pops=qp, db_pops=dp)
    mm = bench.matmul_min_dist(db, q, 1 << 14)
    err["tanimoto_nn"] = _max_abs_err(d, pd)
    check(torch.equal(d, pd) and torch.equal(i, pi),
          f"tanimoto_nn != plain (max abs err {err['tanimoto_nn']}, "
          f"{int((i != pi).sum())} ids differ)")
    check(torch.equal(d, mm), f"tanimoto_nn minima != the matmul path's "
          f"(max abs err {_max_abs_err(d, mm)})")
    print(f"[7a exact] tanimoto_nn {NQ} x {NN:,}: distances and ids "
          f"array-equal to plain, distances to the matmul path's minima "
          f"(mean min distance {float(d.mean()):.4f})", flush=True)

    fast = []
    for n_tile in (None, 1024):
        fd, fi = kernels.tanimoto_nn(q, db, n_tile=n_tile, q_pops=qp,
                                     db_pops=dp, approx=True)
        torch.cuda.synchronize()
        pfd, pfi = kernels.tanimoto_nn_plain(q, db, n_tile=n_tile, q_pops=qp,
                                             db_pops=dp, approx=True)
        derr = float((fd - pfd).abs().max())
        chosen = float((tanimoto_distance(q, db[fi.long()]) - d).abs().max())
        fast.append(derr)
        check(derr <= 2.0 ** -12 and chosen <= 2.0 ** -12,
              f"fast tanimoto_nn n_tile={n_tile}: decoded distances differ "
              f"from plain by {derr}, chosen ids' true distances from the "
              f"exact minima by {chosen} (bounds 2^-12)")
        print(f"[7b fast] n_tile={n_tile or kernels.default_n_tile(NN)}: "
              f"decoded distances within {derr:.3g} of plain, chosen ids' "
              f"true distances within {chosen:.3g} of the exact minima "
              f"(bounds 2^-12); {int((fi != pfi).sum())} ids differ from "
              f"plain", flush=True)
    err["tanimoto_nn_approx"] = max(fast)

    floor = kernels.nn_floor_plain(q, db, 512, 1024)
    unpack = kernels.nn_floor_plain(q, db, 512, 1024, mode="unpack")
    for mode in (*bench_kernel_variants.FLOOR_MODES, "unpack"):
        got = bench_kernel_variants.make_floor_kernel(512, 1024,
                                                      mode=mode)(q, db)
        torch.cuda.synchronize()
        want = unpack if mode == "unpack" else floor
        check(torch.equal(got[:, 0], want),
              f"floor probe {mode} != plain ({_max_abs_err(got[:, 0], want)})")
    err["nn_floor"] = 0.0
    pk = bench_kernel_variants.make_epilogue_probe(512, 1024,
                                                   mode="exact-pk")(q, db)
    torch.cuda.synchronize()
    pk_plain = kernels.nn_epilogue_probe_plain(q, db, 1024, "exact-pk")
    check(torch.equal(pk[:, 0], pk_plain), "exact-pk probe != plain")
    nt = bench_kernel_variants.make_epilogue_probe(512, 1024,
                                                   mode="newton")(q, db)
    torch.cuda.synchronize()
    nerr = _max_abs_err(nt[:, 0], kernels.nn_epilogue_probe_plain(
        q, db, 1024, "newton"))
    check(nerr <= 1e-6, f"newton probe vs plain: {nerr} (bound 1e-6)")
    err["nn_epilogue_probe"] = nerr
    print(f"[7c probes] q_tile 512, n_tile 1024: floor (modes "
          f"{', '.join(bench_kernel_variants.FLOOR_MODES)}), unpack and "
          f"exact-pk array-equal to plain, newton within {nerr:.3g} (bound "
          f"1e-6); max intersection {int(floor.max())}", flush=True)
    return err


def phase_nn(dev) -> tuple:
    """7: the 1-NN kernels at the repo's benchmark problem, then the
    port's benchmark entry points as the path that launches them."""
    t0 = time.perf_counter()
    db = to_torch_packed(random_fingerprints(NN, 1024, 0.1, seed=0), dev)
    # fresh queries: bench.py's own (the library's first rows) would find
    # themselves at distance 0
    q = to_torch_packed(random_fingerprints(NQ, 1024, 0.1, seed=1), dev)
    qp, dp = popcount_rows(q), popcount_rows(db)
    check(int(dp.min()) > 0, "the library has an empty row")
    print(f"[7 library] {NN:,} x 1024-bit, density 0.1, seed 0: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    errs = _nn_checks(q, db, qp, dp)

    lib_ms = _library_ms(q, db, iters=3)
    bound = _tanimoto_bound(NQ, NN, 32, NQ * 8)
    timed = {
        "tanimoto_nn": (
            lambda: kernels.tanimoto_nn(q, db, q_pops=qp, db_pops=dp),
            lambda: kernels.tanimoto_nn_plain(q, db, q_pops=qp, db_pops=dp)),
        "tanimoto_nn_approx": (
            lambda: kernels.tanimoto_nn(q, db, q_pops=qp, db_pops=dp,
                                        approx=True),
            lambda: kernels.tanimoto_nn_plain(q, db, q_pops=qp, db_pops=dp,
                                              approx=True)),
        "nn_floor": (lambda: kernels.nn_floor(q, db, 512, 1024),
                     lambda: kernels.nn_floor_plain(q, db, 512, 1024)),
        "nn_epilogue_probe": (
            lambda: kernels.nn_epilogue_probe(q, db, 1024, "exact-pk", qp,
                                              dp),
            lambda: kernels.nn_epilogue_probe_plain(q, db, 1024, "exact-pk",
                                                    qp, dp)),
    }
    results = {}
    for name, (kernel_fn, plain_fn) in timed.items():
        ms, plain_ms = _turns(kernel_fn, plain_fn, iters=3, warmup=1)
        results[name] = r = dict(max_abs_err=errs[name], ms=ms,
                                 plain_ms=plain_ms, library_ms=lib_ms,
                                 **bound)
        print(f"[7 timing] {name} {NQ} x {NN:,} x 1024 bits: {_fmt(r)}",
              flush=True)
    side = {
        "unpack": (lambda: kernels.nn_floor(q, db, 512, 1024, "unpack"),
                   lambda: kernels.nn_floor_plain(q, db, 512, 1024,
                                                  "unpack")),
        "newton": (lambda: kernels.nn_epilogue_probe(q, db, 1024, "newton",
                                                     qp, dp),
                   lambda: kernels.nn_epilogue_probe_plain(
                       q, db, 1024, "newton", qp, dp)),
    }
    for mode, (kernel_fn, plain_fn) in side.items():
        ms, plain_ms = _turns(kernel_fn, plain_fn, iters=3, warmup=1)
        print(f"[7 timing] {mode} probe: {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms", flush=True)
    del q, db, qp, dp
    torch.cuda.empty_cache()

    _reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main([])
    launches = _counts("tanimoto_nn_approx")
    for line in out.getvalue().splitlines():
        print(f"[7d bench] {line}", flush=True)
    check(rc == 0, f"rad_tpu_torch.bench.main returned {rc}")
    metric = json.loads(out.getvalue().splitlines()[-1])
    check(metric["metric"] == bench.METRIC and metric["value"] > 0,
          f"bench's last line is not the metric: {metric}")
    check(launches["tanimoto_nn_approx"] > 0,
          "rad_tpu_torch.bench never launched tanimoto_nn(approx=True)")

    _reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_kernel_variants.main([
            "--variants", "exact", "approx", "floor", "unpack", "exact-pk",
            "newton"])
    counts = _counts("tanimoto_nn", "tanimoto_nn_approx", "nn_floor",
                     "nn_epilogue_probe")
    for line in out.getvalue().splitlines():
        print(f"[7e variants] {line}", flush=True)
    check(rc == 0, f"rad_tpu_torch.bench_kernel_variants.main returned {rc}")
    for name, count in counts.items():
        check(count > 0, f"{name} never launched by bench_kernel_variants")
    launches["tanimoto_nn_approx"] += counts.pop("tanimoto_nn_approx")
    launches.update(counts)
    print(f"[7 launches] {launches}", flush=True)
    return results, launches


def _campaign_result(state) -> dict:
    """What a campaign leaves behind: the scored set, the scores on it,
    the scoring order and the drop count."""
    scored = state.scored[:-1]
    return dict(scored=scored.cpu().numpy(),
                scores=state.scores[:-1][scored].cpu().numpy(),
                order=tdev.read_order_log(state),
                n_dropped=int(state.n_dropped))


def _same_result(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in a)


def _panel_phase(dev, ctx: dict) -> None:
    """8b: the receptor panel, one score table per campaign."""
    dg, graph, n_top = ctx["dg"], ctx["graph"], ctx["n_top"]
    t0 = time.perf_counter()
    tables = make_receptor_tables(np.asarray(graph.packed), ctx["library"],
                                  PANEL_T)
    tab = torch.from_numpy(tables).to(dev)
    print(f"[8b panel] {PANEL_T} receptor score tables over {N:,} nodes: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ids = torch.arange(n_top, dtype=torch.int32, device=dev)
    dummy = torch.zeros((dg.n_nodes, 1), dtype=torch.uint8, device=dev)

    def panel(t: int, budgets, max_steps: int = 1 << 20):
        sub = tab[:t].contiguous()
        st = multi.prime_multi(multi.init_multi(dg, t), dg, ids,
                               sub[:, :n_top])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = multi.fused_run_multi_tables(st, dg, sub, budgets, batch=8,
                                          max_steps=max_steps)
        torch.cuda.synchronize()
        return st, sub, time.perf_counter() - t0

    def solo(t: int, budget: int) -> dict:
        run = tdev.make_device_run(dg, dummy, tab[t], lambda _r, s: s,
                                   batch=8)
        st = tdev.prime(tdev.init_state(dg, head_capacity=None), dg, ids,
                        tab[t, :n_top])
        return _campaign_result(run(st, budget))

    per_step = {}
    for t in (1, 8, PANEL_T):
        st, sub, dt = panel(t, N_TO_SCORE)
        total, steps = int(st.n_scored.sum()), int(st.n_steps.max())
        check(int(st.n_scored.min()) >= N_TO_SCORE,
              f"8b: a campaign of {t} stopped below its budget")
        # launches and synchronisations of a step, from a profiled window
        # of 30 steps after 100 warm ones
        warm, _, _ = panel(t, 10 ** 9, max_steps=100)
        _, wall_ms, (dev_ms, _, calls) = profiling._profiled(
            lambda: multi.fused_run_multi_tables(warm, dg, sub, 10 ** 9,
                                                 batch=8, max_steps=30))
        per_step[t] = {name: calls.get(name, 0) / 30 for name in (
            "cudaLaunchKernel", "cudaStreamSynchronize", "cudaMemcpyAsync")}
        print(f"[8b panel] T={t}: {total:,} scored in {steps} steps, "
              f"{dt:.2f} s: {total / dt:,.0f} scored/s aggregate, "
              f"{dt / steps * 1e3:.3f} ms/step; per step "
              f"{per_step[t]['cudaLaunchKernel']:.1f} kernel launches, "
              f"{per_step[t]['cudaStreamSynchronize']:.1f} stream "
              f"synchronisations, {per_step[t]['cudaMemcpyAsync']:.1f} "
              f"memcpys, the card busy {dev_ms / wall_ms:.1%} "
              f"({dev_ms / 30:.3f} of {wall_ms / 30:.3f} ms under the "
              f"profiler); frontier dropped {int(st.n_dropped.sum())}",
              flush=True)
        del warm
    l1, lt = (per_step[t]["cudaLaunchKernel"] for t in (1, PANEL_T))
    check(0 < lt < 4 * l1, f"8b: {lt:.0f} launches a step at T={PANEL_T} "
          f"against {l1:.0f} at T=1: the step is not one batched step")
    for t in PANEL_CHECKED:
        got = _campaign_result(multi.campaign_state(st, t))
        check(_same_result(got, solo(t, N_TO_SCORE)),
              f"8b: campaign {t} of the panel differs from its solo run")
        top = np.argsort(tables[t], kind="stable")[:100]
        print(f"[8b panel] campaign {t}: scored set, scores, order and drops "
              f"equal its solo make_device_run run; top-100 found "
              f"{int(got['scored'][top].sum())} at "
              f"{100 * len(got['order']) / N:.2f} % scored", flush=True)
    # unequal budgets: campaigns freeze at different steps
    budgets = [1000 + 50 * t for t in range(PANEL_T)]
    st, _, dt = panel(PANEL_T, budgets)
    steps = st.n_steps.tolist()
    check(steps[0] < steps[-1], f"8b: no campaign froze early ({steps})")
    for t in PANEL_CHECKED:
        check(_same_result(_campaign_result(multi.campaign_state(st, t)),
                           solo(t, budgets[t])),
              f"8b: campaign {t} (budget {budgets[t]}) differs from its "
              f"solo run")
    print(f"[8b panel] budgets {budgets[0]}..{budgets[-1]}: campaigns froze "
          f"after {min(steps)}..{max(steps)} steps ({dt:.2f} s); campaigns "
          f"{PANEL_CHECKED} equal their solo runs", flush=True)


def phase_engine_variants(dev, ctx: dict) -> dict:
    """8: the scalar-loop probes' entry point, the multi-campaign sweeps,
    the host-spilled order log and the packed adjacency."""
    _reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_scalar_probe.main([])
    launches = _counts("scalar_gather", "scalar_checkset", "scalar_chain")
    for line in out.getvalue().splitlines():
        print(f"[8a scalar probes] {line}", flush=True)
    check(rc == 0, f"rad_tpu_torch.bench_scalar_probe.main returned {rc}")
    metric = json.loads(out.getvalue().splitlines()[-1])
    check(metric["metric"] == "scalar_loop_probe" and all(
        metric[k] > 0 for k in ("gather_ns", "checkset_ns", "chain_ns",
                                "breakeven_ns")),
        f"bench_scalar_probe's last line is not the metric: {metric}")
    for name, count in launches.items():
        check(count > 0, f"{name} never launched by bench_scalar_probe")
    print(f"[8a launches] {launches}", flush=True)

    _panel_phase(dev, ctx)

    # 8c: Tanimoto targets, as phase 5 runs one
    dg, packed, pops, n_top = ctx["dg"], ctx["packed"], ctx["pops"], \
        ctx["n_top"]
    rows = torch.tensor([(TARGET + 100_003 * i) % N for i in range(8)],
                        device=dev)
    targets, t_pops = packed[rows], pops[rows]
    seeds = torch.arange(n_top, dtype=torch.int32, device=dev)
    seed_scores = torch.stack([
        tanimoto_rows_to_target(packed[:n_top], pops[:n_top], targets[i],
                                t_pops[i]) for i in range(8)])
    st = multi.prime_multi(multi.init_multi(dg, 8, head_capacity="auto"),
                           dg, seeds, seed_scores)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = multi.fused_run_multi(st, dg, packed, pops, targets, t_pops,
                               100_000, batch=64)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total, steps = int(st.n_scored.sum()), int(st.n_steps.max())
    check(_same_result(_campaign_result(multi.campaign_state(st, 0)),
                       ctx["solo_5a"]),
          "8c: campaign 0 differs from phase 5a's solo fused_run")
    print(f"[8c targets] fused_run_multi, 8 Tanimoto targets, batch 64: "
          f"{total:,} scored in {steps} steps, {dt:.2f} s ({total / dt:,.0f} "
          f"scored/s aggregate, {dt / steps * 1e3:.3f} ms/step); campaign 0 "
          f"equals phase 5a's solo run", flush=True)
    del st

    # 8d: the order log spilled to a file through a small device ring
    host_ids = [m[0] for m in ctx["mols"]]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "order.i32")
        traverser = create_local_traverser(
            ctx["index"], ctx["scoring_fn"], smiles_store=ctx["store"],
            batch_size=8, order_log_spill=path, log_capacity=1024)
        traverser.prime()
        stats = traverser.traverse(n_to_score=N_TO_SCORE)
        mols = traverser.get_molecules()
        traverser.shutdown()
        size = os.path.getsize(path)
    check([m[0] for m in mols] == host_ids and
          [m[1] for m in mols] == [m[1] for m in ctx["mols"]],
          f"8d: the spilled order ({len(mols)}) differs from phase 4's "
          f"({len(host_ids)})")
    check(size == 4 * stats["n_scored"], f"8d: the spill file holds {size} "
          f"bytes for {stats['n_scored']} scored")
    print(f"[8d spill] RADTraverser(order_log_spill=<file>, log_capacity="
          f"1024): {len(mols):,} molecules in phase 4's order from a "
          f"1,024-id device ring; the file holds {size:,} bytes", flush=True)

    # 8e: the bit-packed adjacency under 5c's device-scored run
    graph = ctx["graph"]
    dg_p = tdev.prepare_device_graph(graph, dev, packed_adjacency=True)
    check(dg_p.adj_bits == 20, f"8e: {dg_p.adj_bits}-bit fields at {N:,}")
    table = torch.from_numpy(np.asarray(ctx["true_scores"], np.float64)
                             [ctx["keys"]].astype(np.float32)).to(dev)
    dummy = torch.zeros((dg.n_nodes, 1), dtype=torch.uint8, device=dev)
    run = tdev.make_device_run(dg_p, dummy, table, lambda _r, t: t, batch=8)
    st = tdev.prime(tdev.init_state(dg_p), dg_p, seeds, table[:n_top])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(st, N_TO_SCORE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(tdev.read_order_log(st).tolist() == host_ids,
          "8e: the packed-adjacency order differs from 5c's")
    print(f"[8e packed adjacency] make_device_run over {dg_p.adj_bits}-bit "
          f"fields: {int(st.n_scored):,} scored in {int(st.n_steps)} steps, "
          f"{dt:.2f} s; order identical to 5c's; adjacency table "
          f"{dg_p.adj.numel() * 4:,} bytes packed, {dg.adj.numel() * 4:,} "
          f"unpacked", flush=True)
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
        phase_probed_10m(dev)
        launches.update(phase_approx_1m(dev, context))
        phase_probed_parity(dev)
        nn_timings, nn_launches = phase_nn(dev)
        timings.update(nn_timings)
        launches.update(nn_launches)
        launches.update(phase_engine_variants(dev, context))
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
