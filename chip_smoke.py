#!/usr/bin/env python3
"""Smoke run of rad_tpu_torch on one CUDA card.

    python3 chip_smoke.py            # all phases; needs one CUDA device

Phases, one status line each (plus detail lines):

1. device: ``nvidia-smi`` name and power limit, torch/CUDA versions, and
   the kernels built by nvcc for sm_90a from ``rad_tpu_torch/csrc``, with
   the registers and spill bytes of every instance of the Tanimoto
   kernels (``tanimoto_nn_kernel``, ``tanimoto_nn_wide_kernel``,
   ``tanimoto_matrix_kernel``, ``tanimoto_bucketmin_kernel``), of K1/K2
   and of the ``gather`` / ``checkset`` / ``chain`` probes from the
   ``ptxas -v`` log (a spill fails the run);
2. each CUDA kernel against its plain-torch twin on the card, at the
   shapes its path gives it (1024-bit fingerprints; 2,048 candidates over
   the 1M graph's 1,000,000 ids and 1,066,610 rows): array-equal (the
   bucket kernel's approximate-reciprocal epilogue: decoded distances
   within 2^-14 and chosen entries' true distances within 1e-6), both
   timed with CUDA events, beside the kernel's bound on the card (the
   larger of its 1-bit tensor-core operations over 15,832 TOP/s and its
   bytes over 3.35 TB/s) and, for the Tanimoto kernels, one bf16
   ``torch.mm`` of the unpacked bits (the intersections alone); the bucket
   kernel (4096 x 8192, bucket 64) also replayed from a CUDA graph (the
   kernel without the launch path), and off its 128-row tiles: Q = 1, 65,
   130, 300; N = 64, 192, 640; rows of 1, 6, 8, 32, 64 and 1,025 words
   (one past the range of the branch-free divide: the IEEE-divide
   instance); every bucket of 1, 2, 4, 8, 64 and 128 rows that divides N;
   rows on and off a 16-byte boundary; both epilogues, each case held to
   the bars above; ``tanimoto_matrix`` also off its 128-row tiles (Q = 1,
   65, 130; N = 64, 200, 201; rows of 1, 6, 8, 32, 64 and 1,025 words) and,
   timed through the wrapper and again replayed from a CUDA graph, at the
   skewed shapes the build gives it (256 x 4096, 64 x 19,536), array-equal
   each;
   and the divide of the tensor-core kernels' epilogues compared with
   ``__fdiv_rn`` on every pair of counts it can meet; K1/K2 also with
   their device time (K1 replayed from a CUDA graph, K2 from the
   profiler's kernel time on fresh tables) and the host's microseconds a
   call (``rad_tpu_torch.bench_candidates``), then at K = 1, 1,023, 1,025,
   4,097, 8,192, 8,193 (the first whose dedup table leaves shared memory)
   and 32,768, each random, with a narrow ``to_score``, one id repeated,
   ids ``n - 1``, ids and rows out of range, every candidate invalid in
   phase B and an empty ``to_score``: every output and table array-equal
   to the twins, twice in a row;
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
   (b) the sweep's own build of that point,
   ``rad_tpu_torch.bench_probe_sweep.one_build`` (``build_hnsw_exact``
   with probes 16 of 8192-row clusters, sample 16, qblock, unpadded,
   ``probe_min_n=0``), with both Tanimoto kernels launched and layer 0
   probed (selection streamed into the scan), under ``recording()``:
   ``build.probe_qblocks`` the probed layers' q-blocks of 4,096 rows,
   ``build.probe_bucket`` the ``tanimoto_bucketmin`` launches, 16 a
   q-block (``probed_build_10m`` runs 6a and 6b alone); opened as
   ``HNSWIndex.from_graph``; (c) edge recall@10 and ``index.search``
   recall@10 at ef 32 and 128 over
   500 member queries against brute force (the blocked scan, whose first
   50 queries must equal the plain ``bruteforce_topk``'s), each within its
   bound of the reference's recorded value; (d) ``prime``
   + ``make_device_run`` with the score table at batch 512, K1/K2 on, to
   1 % scored: at least half the true top-1000 found; (e) phase 4's 1M
   build again with ``bucket_approx=True``: at least 99 % of layer-0 slots
   equal; (f) a 32,768-row probed build on the card and on the CPU, both
   granularities: edge-identical; (g), run inside (c) on the 10M graph,
   the two-stage prefix screen of ``search_device`` with 6c's queries and
   truth at ``rad_tpu_torch.bench_prefix``'s configs (0:0, 128:32,
   128:64, 256:32, 256:64; ef 64, E = 4), 128:128 and 1024:128: recall@10
   and queries/s each; the full-width screen keeping E·M0 = 128 giving
   the unscreened ids and distances exactly, every query that 128:128
   moves searched again alone with both beam loops replayed
   (``bench_prefix.full_keep_witness``: the batch's results, and the move
   explained by a tie), and 128:32 keeping at least 0.9 of the
   unscreened ids;
7. the 1-NN sweep of the repo's benchmark problem, 2048 queries x
   1,048,576 rows x 1024 bits (``random_fingerprints``, density 0.1,
   seed 0; the queries drawn with seed 1, not from the library), after a
   ragged case (130 x 4,224, rows of 8 and 6 words, every epilogue; and
   rows of 288, 289 and 1,025 words: the widest resident query tile, the
   wide instance, the IEEE divide) and the wide instance driven at 2048 x
   65,536 x 1,025 words with every epilogue (its launches counted), held
   to the twins and timed against the exact one: (a)
   ``tanimoto_nn`` array-equal to its twin and to the ``matmul`` path's
   minima; (b) the fast epilogue at n_tile 2048 and
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
   order of 5c;
9. the port's other forms of the single-device facade, on phase 4's
   library and graph: (a) the 1M library built cluster-probed (probes 16
   of 8192, sample 16, ``probe_min_n=0``; selection streamed into the
   scan, the port's only probed path) twice, the second time with the
   peak of ``torch.cuda.max_memory_allocated`` taken over each step alone
   (bisection, scans, selection, symmetrization): edge-identical on every
   layer, both Tanimoto kernels launched by each; the seconds per stage,
   the build's peak beside the ``(n_pad + 1) * k * 8`` bytes of the
   candidate tables it never allocates, and the step that sets the peak
   printed; (b) the graph, keyed by node id,
   saved as the v2 serving file (``save(exclude_vectors=True,
   slim=True)``) and written again member by member in 2^18-row chunks
   through ``NpzStreamWriter``: both load (``mmap=True``) to the graph's
   neighbors, derived keys and levels and ``levels_stats``; (c)
   ``HNSWIndex.build(backend="host")`` on 5,000 rows (M = 16,
   ``expansion_add`` 128), searched on the card and by ``search_hnsw`` on
   the host over 200 held-out rows: mean top-5 distances within 0.02,
   recall@10 at ef 128 at least 0.85 against brute force; (d)
   ``smiles_fingerprints`` of 10,000 of phase 4's store strings (the
   native fingerprinter's first use), twice, equal;
10. the other builders on 110,000 molecules x 1024 bits of the mutation-
   tree library (seed 0), M = 16, the size of
   ``benchmarks/bench_build_device.py`` and ``bench_partition.py``: (a)
   ``HNSWIndex.build(backend="device", batch_size=1024)`` (expansion_add
   200) on the first 100,000 rows, recall@10 at ef 128 over 512 member
   queries at least 0.80 and within 0.05 of the exact build of the same
   rows (truth: the blocked brute force, its first 50 queries equal to the
   plain ``bruteforce_topk``'s); (b) ``build_hnsw_device`` on 2,048 rows
   (batch 256) and ``insert_into_graph`` of 256 more, on the card and on
   the CPU, with the dense and with the hashed visited set:
   edge-identical; (c) ``HNSWIndex.insert`` of the last 10,000 rows into
   (a)'s graph: 512 of them found at distance 0, recall@10 over 512 member
   queries of the 110,000 within 0.05 of (a)'s; (d)
   ``build_hnsw_partitioned`` of the 100,000 rows in 4 exact shards
   (expansion_add 128) with both Tanimoto kernels launched: recall@10 at
   ef 64 over 256 member queries at least 0.9 and within 0.05 of the
   exact monolithic build's, seconds per stage; then 4,096 rows on the
   card and on the CPU: edge-identical;
11. the deployment modes on phase 4's graph and store, scored with phase
   4's scores rounded to float32 (the device engine's score type): (a)
   the index CLI (``rad_tpu_torch.scripts.build_index.main``, in this
   process) on 20,000 of the store's strings (``key<TAB>smiles``), 1024
   bits, M = 16, on the card: ``lib.npz`` and ``lib.db`` written, both
   Tanimoto kernels launched, the graph edge-identical to
   ``HNSWIndex(...).build()`` of the same ``smiles_fingerprints``; the
   CLI's fingerprint and build seconds; (b)
   ``create_distributed_traverser`` with 4 workers, then 1, each
   ``prime`` + ``traverse(n_to_score=10_000)`` + ``get_best_molecules(100)``
   on the 1M graph: distinct ids, every score its key's, top-100 recovery
   at least 5x random; scored/s, neighbor fetches and termination reason;
   (c) the graph served over loopback HTTP (``create_hnsw_server`` in a
   thread, with a ``CoordinationService``): ``create_remote_traverser``
   with 1 worker to 10,000 scored, its order equal to (b)'s 1-worker
   order over their common prefix, the server's ``/neighbors`` p50 and
   p99; then a ``ScoringWorker`` over a ``RemoteCoordinationClient``
   joins the server's coordination, scores 1,000 and stops; the host
   engine leaves ``torch.cuda.memory_allocated`` unchanged; (d)
   ``RADTraverser(engine="device", batch_size=1, head_capacity=None)`` to
   2,000 scored: (b)'s 1-worker order over the common prefix; (e)
   ``python -m rad_tpu_torch.scripts.start_hnsw_server`` over (a)'s files
   with ``--enable-coordination`` in a subprocess: ``/info`` reports
   20,000 nodes, a remote traversal scores 1,000; then ``--workers 2`` on
   a fixed free port: both processes answer, and no server process holds
   a ``/dev/nvidia*`` file (this process does).
12. the real-chemistry main path at the DUD-Z morgan example's size
   (``examples/dudez_workflow.py --chemistry morgan``): 40,000 SMILES of
   ``rad_tpu_torch.chem.library.make_smiles_library(seed=0)``, their
   Morgan fingerprints (``chem.morgan_fingerprints_packed``, radius 2,
   1024 bits),
   ``HNSWIndex(connectivity=16, expansion_add=400).add/build`` on the card
   with both Tanimoto kernels launched → ``save``/``load`` (the graph
   equal, ``fp_format_version`` stamped and read back) →
   ``create_local_traverser`` over a store of the SMILES, scored by the
   library's SAR table, batch 4 → ``prime`` → ``traverse`` to 1 % and
   then to 10 % → ``get_best_molecules``: no duplicate ids, the true
   top-100 found at least 5x random at 1 % and more than half at 10 %;
   the first 8,192 rows built on the card and on the CPU edge-identical;
13. the sweep entry points: (a) ``rad_tpu_torch.bench_recall.main`` on
   20,000 rows of the sequential tree library, 256 queries, ef 32 and
   128, the exact builder: recall@10 at ef 128 at least 0.80, its
   brute-force truth (matrix kernel) equal to the plain
   ``bruteforce_topk`` on 50 queries; (b) ``bench_probe_sweep``'s
   ``RecallEval`` over phase 6's library and 6b's graph (the sweep's own
   qblock:16 build): edge recall and recall at ef 32 and 128 equal to
   6c's, its truth taken anew; (c)
   ``bench_probe_sweep.main --library morgan`` at 40,000 molecules, the
   exact baseline and one probed point (csize 4,096, qblock:2): the
   records and the JSON line checked;
14. the engine at 100,000,000 nodes (``rad_tpu_torch.bench_scale.main``,
   m = 8, batch 1024, the graph made on the card in 64 chunks; the budget
   cut from 10M to 1M): ``--mode id --no-score-table`` and ``--mode
   hash``, ``--runs 1``: at least the budget scored, no duplicate in the
   order log, the peak of allocated memory within 15 % of the bytes of
   the graph, the score source and the state; then one 200,000-node graph
   run in id mode without the table on the card and on the CPU: the same
   order log;
15. the multi-device layer on one card as four shards of phase 4's graph
   (``make_mesh(4, devices=[cuda:0] * 4)``): (a) ``build_hnsw_exact(mesh=
   ...)`` on phase 4's library at phase 4's settings, edge-identical to
   phase 4's graph, seconds per stage, the peak of allocated memory and
   the launches of both Tanimoto kernels; (b) ``create_pod_traverser``
   with phase 4's table-lookup scorer, ``prime`` + ``traverse(10_000)`` +
   ``get_best_molecules(100)``, the state replicated and split: at
   ``pipeline_depth=1`` phase 4's order, at depth 2 one duplicate-free
   scored set with every score its key's; (c) ``make_sharded_step`` and
   ``make_sharded_step_full`` to 1 % at batch 64 against single-card
   ``fused_run`` runs of the same budget, batch and frontier layout (order
   log, scored set, scores, drops), ms and kernel launches a step at D =
   1, 2, 4 beside the single-card step's, the synchronisations of a step
   (``torch.cuda.set_sync_debug_mode("warn")``) and ``TrafficMeter``'s
   imbalance; (d) ``make_sharded_step_multi`` with 8 Tanimoto targets,
   each campaign equal to its solo pod run; (e) ``make_sharded_search``
   on the 1-D mesh and ``make_sharded_search_2d`` on a (2, 2) mesh over
   500 member queries at ef 64: ids and distances equal to
   ``search_device`` (one expansion an iteration, the query block each
   data row searches), and ``sharded_bruteforce_topk`` equal to
   ``bruteforce_topk`` on 50 queries; (f) ``shard_graph_streamed`` over
   10,000,000 nodes from host row producers (``bench_scale``'s graph rule,
   m = 8, random 1024-bit rows, numpy generators seeded by shard), the pod
   step to 100,000 scored, the peak of allocated memory within 15 % of
   the bytes of the graph and the state; (g) ``initialize_multihost`` at
   world size 1 over NCCL (a localhost TCP store), ``global_mesh`` and
   one sharded step: 15c's state after one step;
16. the native host path (``rad_tpu_torch.native``, C++ compiled by
   ``g++`` at its first use, 9d's batch) on the card's host: (a) the
   library available, with the ISA flag that compiled it, its seconds and
   path; (b) a single-threaded native build of 9c's 5,000 rows at 9c's
   settings: edge-identical to 9c's numpy graph, both seconds; (c)
   ``HNSWIndex.build(backend="native")`` on every host core over phase
   10's 100,000 rows (expansion_add 200): seconds and rows/s, the graph
   valid; 500 member queries, their truth by the card's blocked brute
   force (the matrix kernel's launches counted, its first 50 queries
   equal to the plain ``bruteforce_topk``'s): the
   card's search at ef 128 recall@10 >= 0.85 and ``search(backend=
   "native")`` >= 0.80, each in queries/s; (d) 11a's 20,000 strings
   through ``smiles_fingerprints_native``, the Python path one by one and
   ``smiles_fingerprints`` (and the first 2,000 through
   ``smiles_fingerprint``, ms a string): array-equal, each timed; (e)
   ``build_hnsw_partitioned(builder="auto")`` of (c)'s rows in 4 shards:
   the native builder taken (no bucket launch), recall@10 at ef 64 >= 0.9
   against (c)'s truth, seconds per stage.

The ``kernels`` line's ``launches`` are each kernel's counts on its own
single-card path (the main path, or the later path that runs it; the
matrix kernel's also hold 16c's brute force); its
``pod_launches`` are the counts on phase 15's paths (the sharded build
and the sharded brute force), 0 for a kernel those paths do not run.

Phase 2 also holds the three probes to their twins on the benchmark's
inputs (8,192 candidates over 2^20 rows); ``gather`` on one CTA and on a
cluster of eight at k = 1 … 65,537 over n = 32 and 2^20 (random ids, one
id repeated, every id n - 1, ids out of range, a table over all of int32
so that the sum wraps); ``checkset`` / ``chain``, on one CTA and on a
cluster of eight, twice in a row, at k = 1 … 32,769 over n = 32 … 2^24
(random ids, one id repeated, every id n - 1, ids out of range, every bit
set, every bit clear), the inputs unmodified; it times each probe eagerly
against its twin, by CUDA-graph replay and on the host's clock, and on 1
against 8 CTAs.

The last four lines are the whole run's seconds, the card's
``nvidia-smi`` line, a JSON object describing each kernel, and ``{"ok":
true, "device": {...}}``. Any failed
check exits non-zero before those lines; so does a machine without CUDA.
The script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from rad_tpu_torch import (HNSWIndex, RADTraverser, _cuda, bench,
                           bench_candidates, bench_kernel_variants,
                           bench_prefix, bench_probe_sweep, bench_recall,
                           bench_scalar_probe, bench_scale,
                           create_distributed_traverser,
                           create_local_traverser, create_remote_traverser,
                           native, profiling)
from rad_tpu_torch.build import exact, partition, probe
from rad_tpu_torch.build.device import build_hnsw_device
from rad_tpu_torch.build.exact import build_hnsw_exact
from rad_tpu_torch.build.incremental import insert_into_graph
from rad_tpu_torch.build.partition import build_hnsw_partitioned
from rad_tpu_torch.build.reference import search_hnsw
from rad_tpu_torch.chem import FP_FORMAT_VERSION, morgan_fingerprints_packed
from rad_tpu_torch.chem.library import make_smiles_library
from rad_tpu_torch.graph.storage import (ArangeKeys, DerivedLevels,
                                         HNSWGraph, NpzStreamWriter)
from rad_tpu_torch.fp import kernels
from rad_tpu_torch.fp.pack import (_hash_fingerprint_bits, pack_fingerprints,
                                   popcount_rows, random_fingerprints,
                                   smiles_fingerprint, smiles_fingerprints,
                                   to_torch_packed)
from rad_tpu_torch.fp.tanimoto import (bruteforce_topk,
                                       bruteforce_topk_blocked,
                                       tanimoto_distance,
                                       tanimoto_rows_to_target)
from rad_tpu_torch.scripts import build_index
from rad_tpu_torch.search import visited
from rad_tpu_torch.search.visited import (use_dense_visited,
                                          visited_capacity_for)
from rad_tpu_torch.server import create_hnsw_server
from rad_tpu_torch.service import LocalHNSWService
from rad_tpu_torch.service.remote import RemoteCoordinationClient
from rad_tpu_torch.store import InMemorySmilesStore, SQLiteSmilesStore
from rad_tpu_torch.synthetic import make_library, make_receptor_tables
from rad_tpu_torch.traverse import candidate_ops
from rad_tpu_torch.traverse import device as tdev
from rad_tpu_torch.traverse import multi
from rad_tpu_torch.traverse.coordinator import CoordinationService
from rad_tpu_torch.traverse.driver import DeviceTraverser
from rad_tpu_torch.traverse.workers import ScoringWorker
from rad_tpu_torch.utils.profiling import recording

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
    "tanimoto_bucket_topk": dict(
        wrapper=kernels.tanimoto_bucket_topk,
        source="rad_tpu_torch/csrc/tanimoto.cu",
        replaces="none: rad_tpu/build/exact.py's host merge loop"),
    "tanimoto_bucket_topk_approx": dict(
        wrapper=kernels.tanimoto_bucket_topk, counter="approx_launches",
        source="rad_tpu_torch/csrc/tanimoto.cu",
        replaces="none: rad_tpu/build/exact.py's host merge loop"),
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
    "tanimoto_nn_wide": dict(
        wrapper=kernels.tanimoto_nn, counter="wide_launches",
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
# phase 6g: bench_prefix's configs (prefix bits:keep; 0:0 unscreened) at ef
# 64 and E = 4
PREFIX_CONFIGS = bench_prefix.parse_configs(bench_prefix.CONFIGS)
PREFIX_EF, PREFIX_E = 64, 4
TRUTH_SAMPLE = 50        # phase 6c: queries held to the plain brute force
# phase 9a: phase 4's library, built cluster-probed (selection streamed
# into the scan)
PROBED_1M = dict(probes=16, probe_csize=8192, probe_sample=16,
                 probe_min_n=0)
CHUNK_ROWS = 1 << 18     # phase 9b: NpzStreamWriter's chunk
HOST_N = 5000            # phase 9c: the host builder's slice
N_SMILES = 10_000        # phase 9d
# phase 10: benchmarks/bench_build_device.py's and bench_partition.py's
# library size (their default --n), the rows inserted after it, and the
# slices built on the card and on the CPU
BUILD_N = 100_000
INSERT_N = 10_000
PARITY_N, PARITY_INSERT, PARITY_BATCH = 2048, 256, 256
PART_PARITY_N = 4096
# phase 11: store strings through the index CLI (smiles_fingerprints hands
# them to the native fingerprinter; the Python path takes ~1 ms a string),
# the host engine's budget (1 % of phase 4's
# graph), the device engine's at batch 1, and the scores of a worker that
# joins over HTTP and of a traversal of the CLI's server
CLI_N = 20_000
HOST_TO_SCORE = N // 100
DEVICE_TO_SCORE = 2_000
REMOTE_N = 1_000
# phase 12: the DUD-Z morgan example's size and settings
# (examples/dudez_workflow.py: 40,000 molecules, M = 16, efC 400, batch 4),
# the top scorers counted, and the slice built on the card and on the CPU
CHEM_N = 40_000
CHEM_TOP = 100
CHEM_PARITY_N = 8192
# phase 13: bench_recall's check size, its recall bar at ef 128, and the
# morgan sweep's size (csize 4,096 gives 10 clusters, enough for 2 probes)
RECALL_N = 20_000
RECALL_BAR = 0.80
SWEEP_MORGAN_N = 40_000
# phase 14: bench_scale's defaults but the budget (10M cut to 1M), the
# size of the CPU-vs-card id run and its budget, and the bar between the
# peak of allocated memory and the bytes of the tensors it holds
SCALE_N, SCALE_BUDGET = 100_000_000, 1_000_000
SCALE_PARITY_N, SCALE_PARITY_BUDGET = 200_000, 50_000
PEAK_TOL = 0.15
# phase 16: member queries of phase 10's library held to the card's brute
# force, the bars of tests/test_native.py (the card's search on the native
# graph at ef 128) and of the native search itself, and 10d's bar
NATIVE_Q = 500
FP_SINGLE_N = 2_000      # 16d: strings through smiles_fingerprint alone
NATIVE_RECALL_BAR, NATIVE_SEARCH_BAR, PART_RECALL_BAR = 0.85, 0.80, 0.9
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
NQ, NN = 2048, 1 << 20   # phase 7: the repo's benchmark problem
PROBE_K, PROBE_N = 8192, 1 << 20   # the scalar-loop probes' problem
PANEL_T = 43             # phase 8b: a DUDE-Z sized receptor panel
PANEL_CHECKED = (0, PANEL_T // 2, PANEL_T - 1)
# published peaks of one H100 SXM (NVIDIA's data sheet): dense int8
# tensor-core operations and HBM3 bytes per second. The data sheet gives no
# 1-bit rate; a 1-bit wgmma (k256) takes as long as an int8 one (k32) and
# covers 8x the depth, so its peak is 8x the int8 peak, 15,832 TOP/s
# (`python -m rad_tpu_torch.bench_mma_rate` read 15,726.7 on an NVIDIA H100
# 80GB HBM3 at 700.00 W). Fingerprints are bits, so that is their peak.
PEAK_INT8_OPS = 1979e12
PEAK_B1_OPS = 8 * PEAK_INT8_OPS
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
    found = {"tanimoto_nn_kernel": 0, "tanimoto_nn_wide_kernel": 0,
             "tanimoto_matrix_kernel": 0, "tanimoto_bucketmin_kernel": 0,
             "tanimoto_bucket_topk_kernel": 0,
             "tanimoto_bucket_topk_merge_kernel": 0,
             "candidate_filter_kernel": 0, "integrate_candidates_kernel": 0,
             "scalar_gather_kernel": 0, "scalar_checkset_kernel": 0,
             "scalar_chain_kernel": 0}
    for name, res in sorted(_cuda.kernel_resources().items()):
        kernel = next((k for k in found if k in name), None)
        if kernel is None or "registers" not in res:
            continue
        found[kernel] += 1
        spill = res["spill_stores"] + res["spill_loads"]
        print(f"[1 build] {name}: {res['registers']} registers, {spill} "
              f"spill bytes", flush=True)
        check(spill == 0, f"{name} spills {spill} bytes")
    want = {"tanimoto_nn_kernel": 5, "tanimoto_nn_wide_kernel": 7,
            "tanimoto_matrix_kernel": 2, "tanimoto_bucketmin_kernel": 3,
            "tanimoto_bucket_topk_kernel": 8,
            "tanimoto_bucket_topk_merge_kernel": 1,
            "candidate_filter_kernel": 2, "integrate_candidates_kernel": 2,
            "scalar_gather_kernel": 2, "scalar_checkset_kernel": 4,
            "scalar_chain_kernel": 4}
    check(found == want, f"ptxas log names instances {found}, not {want}")
    return smi


def _turns(kernel_fn, plain_fn, iters: int = 10, warmup: int = 2):
    """plain, kernel, kernel, plain — then the mean of each pair."""
    p1 = time_ms(plain_fn, iters, warmup)
    k1 = time_ms(kernel_fn, iters, warmup)
    k2 = time_ms(kernel_fn, iters, warmup)
    p2 = time_ms(plain_fn, iters, warmup)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take: 1-bit operations over their
    tensor-core peak or bytes over the memory rate, whichever is larger."""
    t_ops = ops / PEAK_B1_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _tanimoto_bound(nq: int, nn: int, w: int, out_bytes: int) -> dict:
    """2*Q*N*D 1-bit operations; packed rows and popcounts read once, the
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
    lib, graph = r.get("library_ms"), r.get("graph_ms")
    return (f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms"
            + (f"; replayed from a CUDA graph {graph:.4f} ms"
               if graph is not None else "")
            + f"; bound {r['bound_ms']:.4g} ms by {r['bound_by']}"
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
        graph_ms=_graph_ms(
            lambda: kernels.tanimoto_bucketmin(q, db, 64, qp, dp)),
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
        graph_ms=_graph_ms(
            lambda: kernels.tanimoto_bucketmin(q, db, 64, qp, dp,
                                               approx=True)),
        **bound)
    print(f"[2 kernels] tanimoto_bucketmin approx=True 4096x8192 bucket 64: "
          f"decoded distances within {err:.3g} of plain (bound 2^-14), "
          f"chosen entries' true distances within {chosen:.3g} (bound "
          f"1e-6), {int((gid != pgid).sum())} of {gid.numel()} winners "
          f"differ; {_fmt(r)}", flush=True)

    # the exact build's candidate scan: a q-block of a 65,536-row layer
    # (split columns and a merge) and the whole layer in one launch (as the
    # build scans a layer), rows past n_real holding fingerprints; the
    # approx epilogue is held to the card's column-block loop (the twin's
    # f32 reciprocal is not rcp.approx); the q-block is timed against the
    # twin
    lay = to_torch_packed(random_fingerprints(65536, 1024, 0.12, seed=3), dev)
    lay[1::97] = lay[0]
    lp = popcount_rows(lay)
    n_real = 65536 - 1000
    for approx in (False, True):
        name = "tanimoto_bucket_topk" + ("_approx" if approx else "")

        def scan(q1=4096, approx=approx):
            return kernels.tanimoto_bucket_topk(lay, 0, q1, n_real, 64, 64,
                                                pops=lp, approx=approx)

        def twin(q1=4096, approx=approx):
            return kernels.tanimoto_bucket_topk_plain(
                lay, 0, q1, n_real, 64, 64, pops=lp, approx=approx)

        def held_to(q1):
            if not approx:
                return twin(q1)
            blocks = [exact._one_qblock_loop(lay, lp, b0, n_real, 64, 4096,
                                             8192, 64, True)
                      for b0 in range(0, q1, 4096)]
            return (torch.cat([b[0] for b in blocks]),
                    torch.cat([b[1] for b in blocks]))

        for q1 in (4096, 65536):
            (d, i) = scan(q1)
            torch.cuda.synchronize()
            wd, wi = held_to(q1)
            check(torch.equal(d.view(torch.int32), wd.view(torch.int32))
                  and torch.equal(i, wi),
                  f"{name} of rows [0, {q1}) differs from "
                  f"{'the loop' if approx else 'its twin'}")
        ms, plain_ms = _turns(scan, twin)
        results[name] = r = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            library_ms=_library_ms(lay[:4096], lay), graph_ms=None,
            **_tanimoto_bound(4096, 65536, 32, 4096 * 64 * 8))
        held = "the card's loop" if approx else "the plain twin"
        print(f"[2 kernels] {name} 4096x65536 k 64 bucket 64: array-equal "
              f"to {held}, and so is the whole 65536-row layer in one "
              f"launch; {_fmt(r)}", flush=True)
    _bucket_shapes(dev)

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
    _matrix_shapes(dev)
    results.update(_candidate_kernels(dev))
    results.update(_scalar_probes(dev))
    return results


RAGGED_WORDS = (1, 6, 8, 32, 64)   # packed words a row; 6: a 166-bit key set
# one word past the range on which the exact epilogues' branch-free divide
# is checked: the kernels' IEEE-divide instances
WIDE_WORDS = kernels.DIV_CHECKED_WORDS + 1
BUCKET_QS, BUCKET_NS = (1, 65, 130, 300), (64, 192, 640)
BUCKETS = (1, 2, 4, 8, 64, 128)


def _ragged_case(nq: int, nn: int, w: int, dev):
    """Random ``[nq, w]`` queries and an ``[nn, w]`` db with copies of the
    first and last query planted, an empty row, an all-ones row and an
    empty query: no symmetric case for a wrong accumulator map to hide
    behind."""
    rng = np.random.default_rng(1000 * w + nq + nn)
    q, db = (np.packbits(rng.random((n, w * 32)) < 0.15, axis=1,
                         bitorder="little").view(np.uint32)
             for n in (nq, nn))
    db[min(3, nn - 1)], db[nn - 1] = q[0], q[nq - 1]
    db[nn // 2], db[nn // 3] = 0, 0xFFFFFFFF
    if nq > 2:
        q[nq // 2] = 0
    return to_torch_packed(q, dev), to_torch_packed(db, dev)


def _off16(x: torch.Tensor) -> torch.Tensor:
    """The same rows at a storage offset of one word: rows that start off
    a 16-byte boundary whatever W (the kernels' 4-byte staging)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:] = x.reshape(-1)
    return buf[1:].view(x.shape)


def _bucket_shapes(dev) -> None:
    """tanimoto_bucketmin off its 128-row tiles, at every bucket size its
    epilogue reduces differently, rows on and off a 16-byte boundary, both
    epilogues: exact keys array-equal to the twin's; approximate keys
    decoded within 2^-14 of the twin's, the chosen entries' true distances
    within 1e-6."""
    t0 = time.perf_counter()
    cases, worst_d, worst_true = 0, 0.0, 0.0
    for w in RAGGED_WORDS + (WIDE_WORDS,):
        for nq in BUCKET_QS:
            for nn in BUCKET_NS:
                q, db = _ragged_case(nq, nn, w, dev)
                true = kernels.tanimoto_matrix_plain(q, db)
                for bucket in (b for b in BUCKETS if nn % b == 0):
                    want = kernels.tanimoto_bucketmin_plain(q, db, bucket)
                    pd, pgid = kernels.decode_bucket_keys(
                        kernels.tanimoto_bucketmin_plain(q, db, bucket,
                                                         approx=True), bucket)
                    for off, (a, b) in enumerate(((q, db),
                                                  (_off16(q), _off16(db)))):
                        keys = kernels.tanimoto_bucketmin(a, b, bucket)
                        approx = kernels.tanimoto_bucketmin(a, b, bucket,
                                                            approx=True)
                        torch.cuda.synchronize()
                        where = (f"{nq}x{nn}, {w} words, bucket {bucket}"
                                 + (", rows off 16 B" if off else ""))
                        check(torch.equal(keys, want),
                              f"tanimoto_bucketmin {where} != plain (max key "
                              f"diff {_max_abs_err(keys, want)})")
                        d, gid = kernels.decode_bucket_keys(approx, bucket)
                        err = float((d - pd).abs().max())
                        chosen = float((true.gather(1, gid.long())
                                        - true.gather(1, pgid.long()))
                                       .abs().max())
                        check(err <= 2.0 ** -14 and chosen <= 1e-6,
                              f"approx tanimoto_bucketmin {where}: decoded "
                              f"distances differ by {err} (bound 2^-14), "
                              f"chosen entries' true distances by {chosen} "
                              f"(bound 1e-6)")
                        worst_d, worst_true = (max(worst_d, err),
                                               max(worst_true, chosen))
                        cases += 1
    print(f"[2 kernels] tanimoto_bucketmin ragged: {cases} cases (Q "
          f"{BUCKET_QS}, N {BUCKET_NS}, words "
          f"{RAGGED_WORDS + (WIDE_WORDS,)}, buckets {BUCKETS} dividing N, "
          f"rows on and off 16 B): exact array-equal to plain; approx "
          f"decoded within {worst_d:.3g} (bound 2^-14), chosen entries' true "
          f"distances within {worst_true:.3g} (bound 1e-6); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _matrix_shapes(dev) -> None:
    """tanimoto_matrix off its 128-row tiles (Q, N not multiples of the
    tile; N odd, where rows start off an 8-byte boundary; W from 1 word to
    two K chunks), then the skewed shapes the build gives it (an upper
    layer, a probe-table block), timed; and the exhaustive check of the
    divide its epilogue runs."""
    bad = kernels.div_counts_mismatches(dev)
    check(bad == 0, f"div_counts differs from __fdiv_rn on {bad} pairs")
    print("[2 kernels] div_counts: the bits of __fdiv_rn for every pair of "
          "counts 0 <= inter <= union <= 65,536", flush=True)
    shapes = ((1, 64), (65, 200), (130, 64), (130, 201))
    for w in RAGGED_WORDS + (WIDE_WORDS,):
        for nq, nn in shapes:
            q, db = _ragged_case(nq, nn, w, dev)
            out = kernels.tanimoto_matrix(q, db)
            torch.cuda.synchronize()
            plain = kernels.tanimoto_matrix_plain(q, db)
            check(torch.equal(out, plain),
                  f"tanimoto_matrix {nq}x{nn}, {w} words != plain (max abs "
                  f"err {_max_abs_err(out, plain)})")
    print(f"[2 kernels] tanimoto_matrix ragged: array-equal to plain at "
          f"{', '.join(f'{a}x{b}' for a, b in shapes)}, words "
          f"{RAGGED_WORDS + (WIDE_WORDS,)}", flush=True)
    for nq, nn in ((256, 4096), (64, 19536)):
        q = to_torch_packed(random_fingerprints(nq, 1024, 0.12, seed=5), dev)
        db = to_torch_packed(random_fingerprints(nn, 1024, 0.12, seed=6), dev)
        qp, dp = popcount_rows(q), popcount_rows(db)
        out = kernels.tanimoto_matrix(q, db, qp, dp)
        torch.cuda.synchronize()
        plain = kernels.tanimoto_matrix_plain(q, db, qp, dp)
        check(torch.equal(out, plain), f"tanimoto_matrix {nq}x{nn} != plain "
              f"(max abs err {_max_abs_err(out, plain)})")
        ms, plain_ms = _turns(
            lambda: kernels.tanimoto_matrix(q, db, qp, dp),
            lambda: kernels.tanimoto_matrix_plain(q, db, qp, dp), iters=50)
        r = dict(ms=ms, plain_ms=plain_ms, library_ms=_library_ms(q, db),
                 **_tanimoto_bound(nq, nn, 32, nq * nn * 4))
        device_ms = _graph_ms(lambda: kernels.tanimoto_matrix(q, db, qp, dp))
        print(f"[2 kernels] tanimoto_matrix {nq}x{nn}: array-equal to "
              f"plain; {_fmt(r)}; replayed from a CUDA graph "
              f"{device_ms:.4f} ms", flush=True)


def _graph_ms(fn, calls: int = 20) -> float:
    """Milliseconds per call of ``fn`` replayed from a CUDA graph of
    ``calls`` calls: the kernels' time without the host's launch path,
    which a small shape's eager time mostly is."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(calls):
                fn()
    return min(time_ms(graph.replay, 10, warmup=1) for _ in range(3)) / calls


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if torch.equal(a, b):
        return 0.0
    d = (a.double() - b.double()).abs().nan_to_num(nan=float("inf"))
    return float(d.max())


def _candidate_kernels(dev) -> dict:
    """K1 and K2 at the step's shapes against their twins, timed: eager
    (CUDA events, in turns with the twin), device time (K1 replayed from
    a CUDA graph, K2 from the profiler's kernel time on fresh tables) and
    the host's microseconds a call (``rad_tpu_torch.bench_candidates``);
    then the sweep of the dedup table's edges."""
    x = bench_candidates.step_inputs(K, N, R, dev)
    cand, scored, scores, enqueued, row = (
        x[k] for k in ("cand", "scored", "scores", "enqueued", "row"))
    ts = candidate_ops.candidate_filter(cand, scored)
    torch.cuda.synchronize()
    err = _max_abs_err(ts, x["ts"])
    check(err == 0.0 and int((ts >= 0).sum()) > 0,
          f"candidate_filter != plain (max abs err {err})")
    ms, plain_ms = _turns(
        lambda: candidate_ops.candidate_filter(cand, scored),
        lambda: candidate_ops.candidate_filter_plain(cand, scored))
    # K ids read, one scored byte per valid id, K ids written
    n_valid = int(((cand >= 0) & (cand < N)).sum())
    k1 = bench_candidates.k1_times(x)
    results = {"candidate_filter": dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        device_ms=k1["device_ms"], host_us=k1["host_us"],
        **_bound(0.0, 4 * K + n_valid + 4 * K))}
    print(f"[2 kernels] candidate_filter K={K} over N={N:,}: array-equal to "
          f"plain ({int((ts >= 0).sum())} ids); "
          f"{_fmt(results['candidate_filter'])}; device "
          f"{k1['device_ms']:.4f} ms replayed from a CUDA graph (profiler "
          f"{k1['profiler_ms']:.4f} ms), host {k1['host_us']:.2f} us a "
          f"call", flush=True)

    new_scores = x["new_scores"]
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
    del copies
    k2 = bench_candidates.k2_times(x)
    # the four id/score vectors read; per valid id a scored byte read and,
    # when fresh, a score and a byte written; per candidate an enqueued
    # byte read; per push a byte written and a score read; the three
    # masks written
    n_ts = int((ts >= 0).sum())
    nbytes = (16 * K + n_ts + 5 * n_fresh + K + 5 * n_push + K + K + 4 * K)
    results["integrate_candidates"] = r = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        device_ms=k2["device_ms"], host_us=k2["host_us"],
        **_bound(0.0, nbytes))
    print(f"[2 kernels] integrate_candidates kt=kc={K} (and kt={K // 2}), "
          f"N={N:,}, R={R:,}: every output and table array-equal to plain; "
          f"{_fmt(r)}; device {k2['device_ms']:.4f} ms (profiler, fresh "
          f"tables), host {k2['host_us']:.2f} us a call", flush=True)
    _candidate_sweep(dev)
    return results


# candidate counts across the kernels' 1,024-thread rounds and 8,192-
# candidate rounds; 8,193: the first whose dedup table leaves shared memory
SWEEP_K = (1, 1023, 1025, 4097, 8192, 8193, 32768)
SWEEP_KINDS = ("random", "narrow", "one id", "last id", "out of range",
               "phase B invalid", "kt 0")


def _sweep_case(kind: str, k: int, dev):
    """``(to_score, new_scores, cand, row, scored, scores, enqueued)`` as
    device tensors: the step's recipe at ``k`` candidates over ``2k`` ids,
    changed as ``kind`` says."""
    rng = np.random.default_rng(k)
    n = max(2 * k, 64)
    n_rows = n + n // 16 + 1
    cand, scored, scores, enqueued, row = bench_candidates.candidate_case(
        rng, n, k, n_rows)
    if kind == "one id":             # every candidate one unscored id
        j = int(np.flatnonzero(~scored)[0])
        cand[:], row[:], enqueued[j] = j, j, False
    elif kind == "last id":          # ids n - 1, rows r_rows - 1, unmarked
        last = rng.random(k) < 0.3
        cand[last], row[last] = n - 1, n_rows - 1
        scored[n - 1], enqueued[n_rows - 1] = False, False
    elif kind == "out of range":     # ids past n, rows past r_rows
        cand[rng.random(k) < 0.15] = n + 5
        cand[rng.random(k) < 0.05] = -7
        row[rng.random(k) < 0.15] = n_rows + 3
    t = [torch.from_numpy(a).to(dev)
         for a in (cand, scored, scores, enqueued, row)]
    ts = candidate_ops.candidate_filter_plain(t[0], t[1])
    if kind == "one id":
        ts = t[0].clone()
    elif kind == "narrow":
        ts = ts[: k // 3]
    elif kind == "kt 0":
        ts = ts[:0]
    elif kind == "phase B invalid":
        t[0] = torch.full_like(t[0], -1)
    new_scores = torch.rand(ts.shape[0], device=dev)
    return ts, new_scores, t[0], t[4], t[1], t[2], t[3]


def _candidate_sweep(dev) -> None:
    """K1 and K2 against their twins at every ``SWEEP_K`` and kind: every
    output and table array-equal, twice in a row (no state between
    calls)."""
    t0 = time.perf_counter()
    for k in SWEEP_K:
        for kind in SWEEP_KINDS:
            ts, ns, cand, row, scored, scores, enqueued = _sweep_case(kind, k, dev)
            where = f"K={k}, {kind}"
            want = candidate_ops.candidate_filter_plain(cand, scored)
            want2 = candidate_ops.integrate_candidates_plain(
                ts, ns, cand, row, scored.clone(), scores.clone(),
                enqueued.clone())
            for _ in range(2):
                got = candidate_ops.candidate_filter(cand, scored)
                got2 = candidate_ops.integrate_candidates(
                    ts, ns, cand, row, scored.clone(), scores.clone(),
                    enqueued.clone())
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"candidate_filter {where} != plain")
                for name, g, w in zip(["scored", "scores", "enqueued",
                                       "fresh", "push", "cand_score"],
                                      got2, want2):
                    check(torch.equal(g, w),
                          f"integrate_candidates {where}: {name} != plain")
    print(f"[2 kernels] candidate_filter and integrate_candidates at K "
          f"{SWEEP_K} x {SWEEP_KINDS}: every output and table array-equal "
          f"to plain, twice in a row; {time.perf_counter() - t0:.1f} s",
          flush=True)


# the probes' sweep: k across a thread's 8 candidates, a CTA's 4,096-
# candidate round and the cluster's 32,768; n from one bitmap word to 2 MB
PROBE_SWEEP_K = (1, 1023, 1025, 8192, 8193, 32768, 32769)
PROBE_SWEEP_N = (32, 1 << 20, 1 << 22, 1 << 24)
PROBE_SWEEP_KINDS = ("random", "one id", "last id", "out of range",
                     "every bit set", "every bit clear")


def _probe_kind(x: dict, kind: str, n: int) -> dict:
    """The benchmark's inputs ``x`` changed as ``kind`` says (copies)."""
    x = {name: t.clone() for name, t in x.items()}
    k = x["idx"].shape[0]
    if kind == "one id":             # one id repeated k times
        x["idx"].fill_(int(x["idx"][0]) if k else 0)
    elif kind == "last id":          # every id n - 1
        x["idx"].fill_(n - 1)
    elif kind == "out of range":     # a quarter of the ids -5, n, 2^31 - 1
        far = torch.arange(k, device=x["idx"].device) % 4 == 1
        bad = torch.tensor([-5, n, 2 ** 31 - 1], dtype=torch.int32,
                           device=far.device)
        x["idx"][far, 0] = bad[torch.arange(int(far.sum()),
                                            device=far.device) % 3]
    elif kind == "every bit set":
        x["bm"].fill_(-1)
        x["scored"].fill_(-1)
    elif kind == "every bit clear":
        x["bm"].zero_()
        x["scored"].zero_()
    return x


def _check_probes(x: dict, where: str, cluster) -> float:
    """``checkset`` and ``chain`` on ``cluster`` CTAs (None: the wrappers'
    choice) against their twins, twice in a row, the inputs unmodified:
    counts and emit array-equal, ``ssum`` within one f32 ulp and ``out``
    within two. Returns the largest ``ssum`` / ``out`` difference."""
    ops = candidate_ops
    idx, bm, scored, scores = x["idx"], x["bm"], x["scored"], x["scores"]
    kept = [t.clone() for t in (bm, scored, scores)]
    p_checkset = ops.scalar_checkset_plain(idx, bm)
    p_out, p_emit, p_n_new, p_ssum = ops.scalar_chain_plain(idx, scored, bm,
                                                            scores)
    ulp = 2.0 ** -23 * max(float(p_ssum), 1.0)
    worst = 0.0
    for _ in range(2):
        if cluster is None:
            checkset = ops.scalar_checkset(idx, bm)
            out, emit, n_new, ssum = ops.scalar_chain(idx, scored, bm, scores)
        else:
            checkset = ops._checkset_cuda(idx, bm, cluster)
            out, emit, n_new, ssum = ops._chain_cuda(idx, scored, bm, scores,
                                                     cluster)
        torch.cuda.synchronize()
        check(torch.equal(checkset, p_checkset), f"scalar_checkset ({where}):"
              f" {int(checkset)} != {int(p_checkset)}")
        check(int(n_new) == int(p_n_new) and torch.equal(emit, p_emit),
              f"scalar_chain ({where}): n_new {int(n_new)} vs "
              f"{int(p_n_new)}, emit equal: {torch.equal(emit, p_emit)}")
        d_ssum = abs(float(ssum) - float(p_ssum))
        d_out = abs(float(out) - float(p_out))
        check(d_ssum <= ulp and d_out <= 2 * ulp,
              f"scalar_chain ({where}): ssum {float(ssum)} vs "
              f"{float(p_ssum)}, out {float(out)} vs {float(p_out)} (one "
              f"f32 ulp is {ulp:.3g})")
        worst = max(worst, d_ssum, d_out)
    check(all(torch.equal(a, b) for a, b in zip((bm, scored, scores), kept)),
          f"probes ({where}): an input was modified")
    return worst


def _probe_sweep(dev) -> float:
    """``checkset`` and ``chain`` on one CTA and on a cluster of eight at
    every ``PROBE_SWEEP_K`` x ``PROBE_SWEEP_N`` x kind (see
    :func:`_check_probes`)."""
    t0 = time.perf_counter()
    worst = 0.0
    for n in PROBE_SWEEP_N:
        for k in PROBE_SWEEP_K:
            x = bench_scalar_probe.probe_inputs(k, n, dev)
            for kind in PROBE_SWEEP_KINDS:
                case = _probe_kind(x, kind, n)
                for cluster in (1, 8):
                    worst = max(worst, _check_probes(
                        case, f"k={k}, n={n}, {kind}, {cluster} CTA",
                        cluster))
    print(f"[2 kernels] scalar_checkset and scalar_chain on 1 and 8 CTAs at "
          f"k {PROBE_SWEEP_K} x n {PROBE_SWEEP_N} x {PROBE_SWEEP_KINDS}: "
          f"counts and emit array-equal to plain, ssum within one f32 ulp "
          f"(largest difference {worst:.3g}), twice in a row, inputs "
          f"unmodified; {time.perf_counter() - t0:.1f} s", flush=True)
    return worst


# gather: k on both sides of the cluster's threshold (2,048) and of a
# cluster round (32,768), n from one sector to the benchmark's table
GATHER_SWEEP_K = (1, 2047, 2048, 8193, 32769, 65537)
GATHER_SWEEP_N = (32, 1 << 20)
GATHER_SWEEP_KINDS = ("random", "one id", "last id", "out of range",
                      "wrapping")


def _gather_sweep(dev) -> None:
    """``gather`` on one CTA and on a cluster of eight, twice each, at every
    ``GATHER_SWEEP_K`` x ``GATHER_SWEEP_N`` x kind, array-equal to its twin;
    "wrapping" draws the table over all of int32, so the sums wrap."""
    t0 = time.perf_counter()
    cases = 0
    for n in GATHER_SWEEP_N:
        for k in GATHER_SWEEP_K:
            x = bench_scalar_probe.probe_inputs(k, n, dev)
            for kind in GATHER_SWEEP_KINDS:
                if kind == "wrapping":
                    case = dict(x, tab=torch.from_numpy(
                        np.random.default_rng(k).integers(
                            -2 ** 31, 2 ** 31, size=(n, 1), dtype=np.int32))
                        .to(dev))
                else:
                    case = _probe_kind(x, kind, n)
                idx, tab = case["idx"], case["tab"]
                want = candidate_ops.scalar_gather_plain(idx, tab)
                for cluster in (1, 8, 8, 1):
                    got = candidate_ops._gather_cuda(idx, tab, cluster)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want),
                          f"scalar_gather (k={k}, n={n}, {kind}, {cluster} "
                          f"CTA): {int(got)} != {int(want)}")
                    cases += 1
    print(f"[2 kernels] scalar_gather on 1 and 8 CTAs at k {GATHER_SWEEP_K} "
          f"x n {GATHER_SWEEP_N} x {GATHER_SWEEP_KINDS}, twice each: "
          f"array-equal to plain in {cases} launches; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _sectors(entries: torch.Tensor, per_sector: int) -> int:
    """Distinct 32-byte sectors that hold ``entries`` of a table with
    ``per_sector`` entries a sector."""
    return int(torch.unique(entries // per_sector).numel())


def _scalar_probes(dev) -> dict:
    """The three scalar-loop probes against their twins on the benchmark's
    inputs (the gather sum array-equal; checkset and chain as in
    :func:`_check_probes`, by the wrappers' choice of cluster), then
    checkset and chain over the sweep; each probe timed eagerly in turns
    with its twin, split into host and device time
    (``bench_scalar_probe.probe_times``), and checkset and chain on one
    CTA against eight in turns (``bench_scalar_probe.cluster_times``)."""
    ops = candidate_ops
    x = bench_scalar_probe.probe_inputs(PROBE_K, PROBE_N, dev)
    idx, tab, bm = x["idx"], x["tab"], x["bm"]
    scored, scores = x["scored"], x["scores"]
    gather = ops.scalar_gather(idx, tab)
    torch.cuda.synchronize()
    p_gather = ops.scalar_gather_plain(idx, tab)
    check(torch.equal(gather, p_gather),
          f"scalar_gather: {int(gather)} != {int(p_gather)}")
    _gather_sweep(dev)
    chain_err = _check_probes(x, "benchmark inputs", None)
    chain_err = max(chain_err, _probe_sweep(dev))
    # bytes the card must move: idx once, one 32-byte sector per distinct
    # sector of a table that these inputs touch (each input read once: not
    # a sector per access, and not the whole bitmap, which the kernels no
    # longer copy), the outputs once (chain's emit is k ids)
    k, j = PROBE_K, idx.reshape(-1).long()
    j = j[(j >= 0) & (j < PROBE_N)]
    words = _sectors(j >> 5, 8)
    first = torch.unique(j[((bm.reshape(-1)[j >> 5].long() >> (j & 31)) & 1)
                           == 0])
    nbytes = {
        "scalar_gather": 4 * k + 32 * _sectors(j, 8) + 4,
        "scalar_checkset": 4 * k + 32 * words + 4,
        "scalar_chain": (4 * k + 2 * 32 * words + 32 * _sectors(first, 8)
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
        split = bench_scalar_probe.probe_times(kernel_fn)
        results[kernel] = r = dict(
            max_abs_err=chain_err if kernel == "scalar_chain" else 0.0,
            ms=ms, plain_ms=plain_ms, library_ms=lib,
            device_ms=split["device_ms"], host_us=split["host_us"],
            **_bound(0.0, nbytes[kernel]))
        print(f"[2 kernels] {kernel} k={k} n={PROBE_N:,}: "
              f"{ms / k * 1e6:.3f} ns per candidate; "
              f"{_fmt(r, 'tab[idx].sum()')}; device {split['device_ms']:.4f}"
              f" ms replayed from a CUDA graph, host {split['host_us']:.2f} "
              f"us a call, eager {split['eager_ms']:.4f} ms back to back "
              f"({nbytes[kernel]:,} bytes: far under one launch's latency, "
              f"which is the practical floor)", flush=True)
    clusters = bench_scalar_probe.cluster_times(PROBE_K, PROBE_N, dev)
    for name, by_c in clusters.items():
        print(f"[2 kernels] scalar_{name} k={PROBE_K} on 1 vs 8 CTAs, in "
              f"turns 1, 8, 8, 1: device "
              f"{by_c['1']['device_ms']} vs {by_c['8']['device_ms']} ms, "
              f"host {by_c['1']['host_us']} vs {by_c['8']['host_us']} us",
              flush=True)
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
        launches = _counts("tanimoto_bucket_topk", "tanimoto_bucketmin",
                           "tanimoto_matrix")
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

    for name in ("tanimoto_bucket_topk", "tanimoto_matrix"):
        check(launches[name] > 0, f"{name} never launched on the main path")
    check(launches["tanimoto_bucketmin"] == 0, "the exact build launched "
          "the bucket kernel outside the bucket top-k")
    scan_ms = _layer_scan(dev, packed)
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
          f"{t_io:.2f} s; the scan of a whole "
          f"{exact._round_up(n, 8192):,}-row layer in one launch "
          f"{scan_ms:.1f} ms, its first and last 4,096 "
          f"rows and its first q-block's split scan array-equal to the "
          f"plain twin", flush=True)
    print(f"[4 main path] prime+traverse+best: {t_trav:.2f} s, {n_scored:,} "
          f"scored ({n_scored / t_trav:,.0f} scored/s, {dev_stats['steps']} "
          f"steps, host scoring {dev_stats['scoring_time']:.2f} s, device "
          f"calls {dev_stats['device_time']:.2f} s, frontier dropped "
          f"{dev_stats['frontier_dropped']}); "
          f"top-100 found {found} ({found / max(random_expect, 1e-9):.1f}x "
          f"random); launches {launches}", flush=True)
    return launches, context


def _layer_scan(dev, packed: np.ndarray) -> float:
    """The build's candidate scan of ``packed`` as one zero-padded layer, as
    the build launches it (one launch, k 64, bucket 64): its first and last
    4,096 rows, and its first q-block scanned alone (split columns and a
    merge), held to the plain twin. Returns the launch's milliseconds."""
    n = packed.shape[0]
    n_pad = exact._round_up(n, 8192)
    lay = torch.zeros((n_pad, packed.shape[1]), dtype=torch.int32,
                      device=dev)
    lay[:n] = to_torch_packed(packed, dev)
    lp = popcount_rows(lay)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d, i = kernels.tanimoto_bucket_topk(lay, 0, n_pad, n, 64, 64, pops=lp)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    qd, qi = kernels.tanimoto_bucket_topk(lay, 0, 4096, n, 64, 64, pops=lp)
    for q0, got in ((0, (d[:4096], i[:4096])), (0, (qd, qi)),
                    (n_pad - 4096, (d[-4096:], i[-4096:]))):
        pd, pi = kernels.tanimoto_bucket_topk_plain(lay, q0, q0 + 4096, n, 64,
                                                    64, pops=lp)
        check(torch.equal(got[0].view(torch.int32), pd.view(torch.int32))
              and torch.equal(got[1], pi), f"4: the scan of rows [{q0}, "
              f"{q0 + 4096}) of the {n_pad:,}-row layer differs from the "
              f"plain twin")
    return ms


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


def _prefix_screen(g, q, truth, dev) -> None:
    """6g: the two-stage prefix screen on the 10M graph, 6c's queries and
    truth. Keeping the whole wave (E·M0) only reorders each wave: over
    the full row width that order is the distance order and the search
    must be the unscreened one, ids and distances; at 128 bits each query
    whose result moves must be explained by a tie
    (``bench_prefix.full_keep_witness``). 128:32 must keep >= 0.9 of the
    unscreened ids."""
    t0 = time.perf_counter()
    full = PREFIX_E * 2 * g.connectivity
    width = 32 * np.asarray(g.packed).shape[1]
    res = bench_prefix.sweep(g, q, truth, PREFIX_CONFIGS + [(128, full),
                                                            (width, full)],
                             10, PREFIX_EF, PREFIX_E, dev)
    base = res[0]
    check(base["prefix_bits"] == 0, "6g: the first config is not 0:0")
    for r in res:
        overlap = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                                 for a, b in zip(r["ids"], base["ids"])]))
        same = float(np.mean((r["dists"] == base["dists"]).all(1)))
        print(f"[6g prefix] {r['prefix_bits']}:{r['keep']} ef "
              f"{PREFIX_EF} E {PREFIX_E}: recall@10 {r['recall']:.4f}, "
              f"{r['qps']:,.0f} queries/s ({r['seconds']:.3f} s for "
              f"{len(q)}), id overlap with 0:0 {overlap:.4f}, queries with "
              f"0:0's distances {same:.4f}", flush=True)
        if (r["prefix_bits"], r["keep"]) == (128, 32):
            check(overlap >= 0.9, f"6g: 128:32 keeps {overlap:.4f} of the "
                  f"unscreened ids (< 0.9)")
    check(np.array_equal(res[-1]["dists"], base["dists"])
          and np.array_equal(res[-1]["ids"], base["ids"]),
          f"6g: the {width}-bit screen keeping E*M0 = {full} is not the "
          f"unscreened search")
    _full_keep_ties(g, q, res[-2], base, full, dev)
    print(f"[6g prefix] the {width}-bit screen keeping E*M0 = {full} gives "
          f"the unscreened ids and distances exactly; 6g "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _full_keep_ties(g, q, r, base, full: int, dev) -> None:
    """6g: every query whose full-keep result ``r`` (a prefix screen
    keeping E·M0) differs from the unscreened one, searched again alone with both loops replayed: the
    same results as in the batch, and the move explained by a tie."""
    moved = np.flatnonzero(~((r["dists"] == base["dists"]).all(1)
                             & (r["ids"] == base["ids"]).all(1)))
    if not len(moved):
        print(f"[6g ties] {r['prefix_bits']}:{full} gives the unscreened "
              f"ids and distances on every query", flush=True)
        return
    n = len(g)
    # the batch of 500 took the hashed visited set: so do these queries
    cap = (None if use_dense_visited(len(q), n)
           else visited_capacity_for(PREFIX_EF, 2 * g.connectivity, n))
    t0 = time.perf_counter()
    bits = r["prefix_bits"]
    found, (da, ia), (db, ib) = bench_prefix.full_keep_witness(
        g, q[moved], bits, 10, PREFIX_EF, PREFIX_E, dev,
        visited_capacity=cap)
    check(np.array_equal(da, base["dists"][moved])
          and np.array_equal(ia, base["ids"][moved])
          and np.array_equal(db, r["dists"][moved])
          and np.array_equal(ib, r["ids"][moved]),
          "6g: the moved queries searched alone end elsewhere than in the "
          "batch")
    lines = []
    for j, w in zip(moved.tolist(), found):
        check(w["fault"] is None, f"6g: query {j}: {w['fault']}")
        check(not w["same"], f"6g: query {j} did not move when replayed")
        lines.append(f"query {j}: " + (
            f"first expands other ids at iteration {w['step']}, tied at "
            f"distance(s) {w['tie']}" if w["step"] is not None else
            "the same expansions, equal distances, tied ids reordered"))
    print(f"[6g ties] {bits}:{full} moves {len(moved)} of {len(q)} queries, "
          f"each by a tie ({time.perf_counter() - t0:.1f} s): "
          + "; ".join(lines), flush=True)


def probed_build_10m(dev):
    """Phases 6a and 6b: the 10M library and its probed build, under
    ``recording()``. Returns ``(packed, true_scores, graph)``."""
    t0 = time.perf_counter()
    packed, true_scores = make_library(N10, seed=0, batch=1 << 20)
    print(f"[6a library] {N10:,} x 1024-bit (make_library, batch 2^20): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # bench_probe_sweep's qblock:16 point, built by the sweep itself
    # (phase 13b evaluates this graph through the sweep's RecallEval)
    _reset_counts()
    stage = {}
    with recording() as rec:
        g, t_build = bench_probe_sweep.one_build(
            packed, "qblock", 16, None, csize=8192, probe_sample=16, seed=0,
            device=dev, stage_times=stage)
    launches = _counts("tanimoto_bucketmin", "tanimoto_matrix")
    probed = stage["probed_layers"]
    for name, count in launches.items():
        check(count > 0, f"{name} never launched in the 10M probed build")
    _check_graph(g)
    check(0 in probed, f"layer 0 did not probe (probed layers {probed})")
    # every probed layer scans its real q-blocks, each its 16 clusters
    qblocks = sum(-(-g.layer_sizes[l] // 4096) for l in probed)
    counters = {name: rec.counters.get(name, 0) for name in (
        "build.probe_qblocks", "build.probe_bucket", "build.probe_matrix")}
    check(counters["build.probe_qblocks"] == qblocks,
          f"6b: build.probe_qblocks {counters['build.probe_qblocks']} for "
          f"{qblocks} q-blocks of the probed layers {probed}")
    check(counters["build.probe_bucket"]
          == launches["tanimoto_bucketmin"] == 16 * qblocks
          and counters["build.probe_matrix"] == 0,
          f"6b: cluster scans {counters} against "
          f"{launches['tanimoto_bucketmin']} tanimoto_bucketmin launches "
          f"and 16 x {qblocks} probes")
    print(f"[6b probed build] bench_probe_sweep.one_build, {N10:,}, M=16, "
          f"probes 16 of 8192, qblock, "
          f"layers {g.layer_sizes}, probed layers {probed}: "
          f"{t_build:.1f} s (bisection {stage['bisection']:.2f} s, probe "
          f"tables {stage['probe_tables']:.2f} s, candidates "
          f"{stage['candidates']:.2f} s, selection {stage['selection']:.2f}"
          f" s, symmetrization {stage['symmetrization']:.2f} s); launches "
          f"{launches}; counters {counters}", flush=True)
    return packed, true_scores, g


def phase_probed_10m(dev) -> dict:
    packed, true_scores, g = probed_build_10m(dev)
    index = HNSWIndex.from_graph(g, device=dev)

    qidx = np.random.default_rng(17).choice(N10, 500, replace=False)
    q = packed[qidx]
    t0 = time.perf_counter()
    truth_d, truth = index.search(q, k=10, exact=True)
    t_truth = time.perf_counter() - t0
    # the blocked scan draws its distances from the matrix kernel: a
    # sample of the queries is held to the plain scan, torch alone
    db = to_torch_packed(np.asarray(g.packed), dev)
    t0 = time.perf_counter()
    d_plain, i_plain = bruteforce_topk(
        to_torch_packed(q[:TRUTH_SAMPLE], dev), db, 10)
    t_plain = time.perf_counter() - t0
    del db
    keys_all = np.asarray(g.keys)
    plain_keys = keys_all[i_plain.cpu().numpy()]
    check(np.array_equal(plain_keys, truth[:TRUTH_SAMPLE])
          and np.array_equal(d_plain.cpu().numpy(),
                             truth_d[:TRUTH_SAMPLE]),
          f"6c: the blocked brute force differs from the plain one on its "
          f"first {TRUTH_SAMPLE} queries")
    print(f"[6c recall] 500 member queries (rng 17), brute-force truth "
          f"{t_truth:.1f} s (blocked, matrix kernel); its first "
          f"{TRUTH_SAMPLE} queries' ids and distances equal the plain "
          f"bruteforce_topk's ({t_plain:.1f} s)", flush=True)
    got = _graph_recall(index, q, qidx, truth)
    edge_ref = REF_RECALL["edge"][0]
    print(f"[6c recall] edge recall@10 {got['edge']:.4f} is "
          f"{'' if abs(got['edge'] - edge_ref) <= EDGE_REF_TOL else 'not '}"
          f"within the reference's own {EDGE_REF_TOL} of {edge_ref}",
          flush=True)
    for name, (ref, tol) in REF_RECALL.items():
        check(abs(got[name] - ref) <= tol, f"10M {name} recall@10 "
              f"{got[name]:.4f} is not within {tol} of {ref}")
    _prefix_screen(g, q, truth, dev)

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
    # phase 13b reads this graph through bench_probe_sweep: keep the
    # library, the graph (its host arrays) and 6c's recalls
    g.__dict__.pop("_search_prep", None)
    g.__dict__.pop("_prefix_prep", None)
    del index, dg, table, dummy, st
    return dict(library=packed, graph=g, recall=got)


def phase_approx_1m(dev, ctx: dict) -> dict:
    _reset_counts()
    torch.cuda.synchronize()
    stage = {}
    g = build_hnsw_exact(ctx["library"], connectivity=16, seed=0,
                         device=dev, bucket_approx=True, stage_times=stage)
    launches = _counts("tanimoto_bucket_topk_approx", "tanimoto_bucket_topk",
                       "tanimoto_bucketmin_approx")
    check(launches["tanimoto_bucket_topk_approx"] > 0,
          "the approximate bucket epilogue never launched")
    check(launches["tanimoto_bucket_topk"] == 0,
          "the exact bucket epilogue ran in the bucket_approx build")
    check(launches["tanimoto_bucketmin_approx"] == 0, "the bucket_approx "
          "build launched the bucket kernel outside the bucket top-k")
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
    return {name: launches[name] for name in (
        "tanimoto_bucket_topk_approx", "tanimoto_bucketmin_approx")}


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


def _nn_ragged(dev) -> None:
    """Every epilogue of the 1-NN kernel against its twin with Q and N off
    the kernel's 128-row tiles (N a multiple of n_tile = 64 only), rows of
    8 words (16-byte staging) and 6 (4-byte staging)."""
    nq, nn, n_tile = 130, 4224, 64
    for w in (8, 6):
        q, db = _ragged_case(nq, nn, w, dev)
        d, i = kernels.tanimoto_nn(q, db, n_tile=n_tile)
        torch.cuda.synchronize()
        pd, pi = kernels.tanimoto_nn_plain(q, db, n_tile=n_tile)
        check(torch.equal(d, pd) and torch.equal(i, pi),
              f"ragged tanimoto_nn, {w} words != plain")
        check(float(d[0]) == 0 and float(d[-1]) == 0,
              "ragged tanimoto_nn missed a planted copy")
        fd, fi = kernels.tanimoto_nn(q, db, n_tile=n_tile, approx=True)
        pfd, _ = kernels.tanimoto_nn_plain(q, db, n_tile=n_tile, approx=True)
        true = kernels.tanimoto_matrix_plain(q, db)
        chosen = true.gather(1, fi.long()[:, None])[:, 0]
        derr = float((fd - pfd).abs().max())
        cerr = float((chosen - true.amin(dim=1)).abs().max())
        check(derr <= 2.0 ** -12 and cerr <= 2.0 ** -12,
              f"ragged fast tanimoto_nn, {w} words: {derr}, {cerr} (bounds "
              f"2^-12)")
        check(torch.equal(kernels.nn_floor(q, db, 1, n_tile),
                          kernels.nn_floor_plain(q, db, 1, n_tile)),
              f"ragged floor probe, {w} words != plain")
        check(torch.equal(
            kernels.nn_epilogue_probe(q, db, n_tile, "exact-pk"),
            kernels.nn_epilogue_probe_plain(q, db, n_tile, "exact-pk")),
            f"ragged exact-pk probe, {w} words != plain")
        nerr = _max_abs_err(
            kernels.nn_epilogue_probe(q, db, n_tile, "newton"),
            kernels.nn_epilogue_probe_plain(q, db, n_tile, "newton"))
        check(nerr <= 1e-6, f"ragged newton probe, {w} words: {nerr}")
    print(f"[7 ragged] {nq} x {nn:,}, 8 and 6 words, n_tile {n_tile}: exact "
          f"(distances and ids), floor and exact-pk array-equal to plain, "
          f"fast within 2^-12, newton within 1e-6", flush=True)
    # the widest resident query tile (nine chunks, the largest shared-memory
    # request of any launch), one word more (the wide instance), and one
    # word past the branch-free divide's range (the IEEE divide)
    wide = (kernels.NN_MAX_WORDS, kernels.NN_MAX_WORDS + 1, WIDE_WORDS)
    for w in wide:
        q, db = _ragged_case(nq, 640, w, dev)
        d, i = kernels.tanimoto_nn(q, db, n_tile=n_tile)
        torch.cuda.synchronize()
        pd, pi = kernels.tanimoto_nn_plain(q, db, n_tile=n_tile)
        check(torch.equal(d, pd) and torch.equal(i, pi),
              f"tanimoto_nn at {w} words != plain")
        check(float(d[0]) == 0 and float(d[-1]) == 0,
              f"tanimoto_nn at {w} words missed a planted copy")
        check(torch.equal(kernels.nn_floor(q, db, 1, n_tile),
                          kernels.nn_floor_plain(q, db, 1, n_tile)),
              f"floor probe at {w} words != plain")
        check(torch.equal(
            kernels.nn_epilogue_probe(q, db, n_tile, "exact-pk"),
            kernels.nn_epilogue_probe_plain(q, db, n_tile, "exact-pk")),
            f"exact-pk probe at {w} words != plain")
        nerr = _max_abs_err(
            kernels.nn_epilogue_probe(q, db, n_tile, "newton"),
            kernels.nn_epilogue_probe_plain(q, db, n_tile, "newton"))
        fd, _ = kernels.tanimoto_nn(q, db, n_tile=n_tile, approx=True)
        pfd, _ = kernels.tanimoto_nn_plain(q, db, n_tile=n_tile, approx=True)
        derr = float((fd - pfd).abs().max())
        check(nerr <= 1e-6 and derr <= 2.0 ** -12,
              f"tanimoto_nn at {w} words: newton {nerr} (bound 1e-6), fast "
              f"{derr} (bound 2^-12)")
    print(f"[7 ragged] {nq} x 640, {', '.join(map(str, wide))} words: "
          f"exact, floor and exact-pk array-equal to plain, fast within "
          f"2^-12, newton within 1e-6", flush=True)


def _nn_wide(dev) -> tuple:
    """The wide instance at ``WIDE_WORDS`` words a row, 2048 x 65,536 (bits
    set with probability 1/8, the AND of three random words): every
    epilogue through the public wrappers with the launch counter set to 0
    just before and read just after, then each result held to its twin
    (exact, floor and exact-pk array-equal, fast within 2^-12, newton within
    1e-6), then the exact epilogue timed against its twin. Returns ``(the
    kernels-line entry, launches)``."""
    nq, nn, w = NQ, 1 << 16, WIDE_WORDS
    rng = np.random.default_rng(7)
    q, db = (to_torch_packed(np.bitwise_and.reduce(
        rng.integers(0, 1 << 32, size=(3, n, w), dtype=np.uint32)), dev)
        for n in (nq, nn))
    qp, dp = popcount_rows(q), popcount_rows(db)
    kernels.tanimoto_nn.wide_launches = 0
    d, i = kernels.tanimoto_nn(q, db, q_pops=qp, db_pops=dp)
    fd, _ = kernels.tanimoto_nn(q, db, q_pops=qp, db_pops=dp, approx=True)
    floor = kernels.nn_floor(q, db, 1, 1024)
    pk = kernels.nn_epilogue_probe(q, db, 1024, "exact-pk", qp, dp)
    nt = kernels.nn_epilogue_probe(q, db, 1024, "newton", qp, dp)
    torch.cuda.synchronize()
    launches = kernels.tanimoto_nn.wide_launches
    check(launches == 5, f"the wide instance launched {launches} times for "
          f"five calls at {w} words")
    pd, pi = kernels.tanimoto_nn_plain(q, db, q_pops=qp, db_pops=dp)
    check(d.shape == (nq,) and bool(torch.isfinite(d).all())
          and torch.equal(d, pd) and torch.equal(i, pi),
          f"tanimoto_nn {nq} x {nn:,} x {w} words != plain "
          f"({int((i != pi).sum())} ids differ)")
    pfd, _ = kernels.tanimoto_nn_plain(q, db, q_pops=qp, db_pops=dp,
                                       approx=True)
    derr = float((fd - pfd).abs().max())
    check(torch.equal(floor, kernels.nn_floor_plain(q, db, 1, 1024)),
          f"floor probe at {w} words != plain")
    check(torch.equal(pk, kernels.nn_epilogue_probe_plain(
        q, db, 1024, "exact-pk", qp, dp)), f"exact-pk probe at {w} words "
          f"!= plain")
    nerr = _max_abs_err(nt, kernels.nn_epilogue_probe_plain(
        q, db, 1024, "newton", qp, dp))
    check(derr <= 2.0 ** -12 and nerr <= 1e-6,
          f"tanimoto_nn at {nq} x {nn:,} x {w} words: fast {derr} (bound "
          f"2^-12), newton {nerr} (bound 1e-6)")
    ms, plain_ms = _turns(
        lambda: kernels.tanimoto_nn(q, db, q_pops=qp, db_pops=dp),
        lambda: kernels.tanimoto_nn_plain(q, db, q_pops=qp, db_pops=dp),
        iters=3, warmup=1)
    # the floor probe: the staging and the product with a 32-bit max, so
    # the exact time less this is what its epilogue costs
    floor_ms = time_ms(lambda: kernels.nn_floor(q, db, 1, 1024), 3, 1)
    r = dict(max_abs_err=_max_abs_err(d, pd), ms=ms, plain_ms=plain_ms,
             library_ms=_library_ms(q, db, 3),
             **_tanimoto_bound(nq, nn, w, nq * 8))
    print(f"[7 wide] tanimoto_nn wide instance {nq} x {nn:,} x {w} words "
          f"({32 * w:,} bits), {launches} launches (exact, fast, floor, "
          f"exact-pk, newton): exact, floor and exact-pk array-equal to "
          f"plain, fast within {derr:.3g} (bound 2^-12), newton within "
          f"{nerr:.3g} (bound 1e-6); exact {_fmt(r)}; the floor probe "
          f"{floor_ms:.4f} ms", flush=True)
    return r, launches


def phase_nn(dev) -> tuple:
    """7: the 1-NN kernels at the repo's benchmark problem, then the
    port's benchmark entry points as the path that launches them."""
    _nn_ragged(dev)
    wide, wide_launches = _nn_wide(dev)
    torch.cuda.empty_cache()
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
    results = {"tanimoto_nn_wide": wide}
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
    launches.update(counts, tanimoto_nn_wide=wide_launches)
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
        _, wall_ms, (dev_ms, _, calls, _) = profiling._profiled(
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


# phase 9a: the build's steps whose peaks of allocated memory are taken
# alone (leaves: none calls another of them)
PEAK_STEPS = ((probe, "bisect_clusters", "bisection"),
              (exact, "_one_qblock_probed", "probed scan"),
              (exact, "_scan", "exact scan"),
              (exact, "_select_neighbors", "selection"),
              (exact, "_dist_rows", "selected distances"),
              (exact, "_symmetrize", "symmetrization"))


@contextlib.contextmanager
def _step_peaks(dev, peaks: dict):
    """Record in ``peaks`` each of :data:`PEAK_STEPS`' largest peak of
    allocated memory over one call (the peak statistics reset before
    each call)."""
    def wrap(fn, name):
        def peaked(*a, **kw):
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            out = fn(*a, **kw)
            torch.cuda.synchronize(dev)
            peaks[name] = max(peaks.get(name, 0),
                              torch.cuda.max_memory_allocated(dev))
            return out
        return peaked

    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in PEAK_STEPS]
    for (mod, attr, fn), (_, _, name) in zip(saved, PEAK_STEPS):
        setattr(mod, attr, wrap(fn, name))
    try:
        yield peaks
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _streamed_build(dev, ctx: dict) -> None:
    """9a: phase 4's library built cluster-probed, selection streamed into
    the scan (the port's only probed path), twice: the second with each
    step's peak memory taken alone, to find what sets the build's peak.
    Edge-identical, both Tanimoto kernels launched in each."""
    lib = ctx["library"]
    out = []
    for steps in (False, True):
        _reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        stage, peaks = {}, {}
        t0 = time.perf_counter()
        with (_step_peaks(dev, peaks) if steps
              else contextlib.nullcontext()):
            g = build_hnsw_exact(lib, connectivity=16, seed=0, device=dev,
                                 stage_times=stage, **PROBED_1M)
        torch.cuda.synchronize()
        out.append(dict(
            graph=g, stage=stage, seconds=time.perf_counter() - t0,
            base=base, peak=torch.cuda.max_memory_allocated(dev) - base,
            peaks={k: v - base for k, v in peaks.items()},
            launches=_counts("tanimoto_bucketmin", "tanimoto_matrix")))
    a, b = out
    for r in out:
        check(0 in r["stage"]["probed_layers"], "9a: layer 0 did not probe")
        for name, count in r["launches"].items():
            check(count > 0, f"9a: {name} never launched in the build")
    check(a["graph"].layer_sizes == b["graph"].layer_sizes,
          "9a: layer sizes differ")
    for l, (x, y) in enumerate(zip(a["graph"].neighbors,
                                   b["graph"].neighbors)):
        diff = int((x != y).sum())
        check(diff == 0, f"9a: layer {l}: {diff} slots differ between the "
              f"two builds")
    g = a["graph"]
    n_pad = -(-len(g) // 8192) * 8192
    tables = (n_pad + 1) * 64 * 8
    sg = a["stage"]
    print(f"[9a streamed build] {len(lib):,}, M=16, probes "
          f"{PROBED_1M['probes']} of {PROBED_1M['probe_csize']}: "
          f"{a['seconds']:.2f} s (bisection {sg['bisection']:.2f}, probe "
          f"tables {sg['probe_tables']:.2f}, candidates "
          f"{sg['candidates']:.2f}, selection {sg['selection']:.2f}, "
          f"symmetrization {sg['symmetrization']:.2f} s); peak "
          f"{a['peak'] / 2**30:.3f} GiB over the {a['base'] / 2**30:.3f} "
          f"GiB held before; layer 0's candidate tables, never allocated, "
          f"would be (n_pad + 1) * k * 8 = {tables / 2**30:.3f} GiB; "
          f"launches {a['launches']}", flush=True)
    top = max(b["peaks"], key=b["peaks"].get)
    print(f"[9a streamed build] again with each step's peak taken alone "
          f"({b['seconds']:.2f} s), edge-identical on layers "
          f"{g.layer_sizes}; peaks over the memory held before: "
          + ", ".join(f"{k} {v / 2**30:.3f} GiB"
                      for k, v in b["peaks"].items())
          + f"; the build's peak {a['peak'] / 2**30:.3f} GiB is "
          + (f"{top}'s" if b["peaks"][top] >= 0.99 * a["peak"]
             else "set outside these steps"), flush=True)


def _storage(ctx: dict) -> None:
    """9b: phase 4's graph, keyed by node id as a serving file is, saved
    slim and written again member by member in chunks: both files map
    to the graph's neighbors, derived keys and levels, and its stats."""
    graph = ctx["graph"]
    ided = dataclasses.replace(graph, keys=np.arange(len(graph),
                                                     dtype=np.int64))
    stats = [vars(s) for s in graph.levels_stats()]
    with tempfile.TemporaryDirectory() as tmp:
        try:
            graph.save(os.path.join(tmp, "x.npz"), exclude_vectors=True,
                       slim=True)
            check(False, "9b: slim saved a graph without identity keys")
        except ValueError:
            pass
        slim = os.path.join(tmp, "slim.npz")
        t0 = time.perf_counter()
        ided.save(slim, exclude_vectors=True, slim=True)
        t_save = time.perf_counter() - t0
        streamed = os.path.join(tmp, "streamed.npz")
        t0 = time.perf_counter()
        w = NpzStreamWriter(streamed)
        for l, t in enumerate(graph.neighbors):
            with w.member(f"neighbors_{l}", t.shape, t.dtype) as m:
                for r0 in range(0, t.shape[0], CHUNK_ROWS):
                    m.write(np.asarray(t[r0:r0 + CHUNK_ROWS]))
        w.close({"ndim": graph.ndim, "connectivity": graph.connectivity,
                 "n_layers": len(graph.neighbors), "exclude_vectors": True,
                 "version": 2, "identity_keys": True, "derived_levels": True,
                 "edges_per_layer": [s["edges"] for s in stats]})
        t_stream = time.perf_counter() - t0
        for path in (slim, streamed):
            g = HNSWGraph.load(path, mmap=True)
            check(isinstance(g.keys, ArangeKeys)
                  and isinstance(g.levels, DerivedLevels),
                  f"9b: {path} does not derive keys and levels")
            check(np.array_equal(np.asarray(g.levels),
                                 np.asarray(graph.levels)),
                  "9b: derived levels differ")
            check(g.get_node_ids_from_keys([0, len(g) - 1])
                  == [0, len(g) - 1], "9b: derived keys differ")
            for l, (a, b) in enumerate(zip(g.neighbors, graph.neighbors)):
                check(np.array_equal(a, b), f"9b: layer {l} differs")
            check([vars(s) for s in g.levels_stats()] == stats,
                  "9b: levels_stats differ")
        print(f"[9b storage] {len(graph):,} rows: save(slim) "
              f"{os.path.getsize(slim) / 1e6:.1f} MB in {t_save:.2f} s; "
              f"NpzStreamWriter in {CHUNK_ROWS:,}-row chunks "
              f"{os.path.getsize(streamed) / 1e6:.1f} MB in {t_stream:.2f} s;"
              f" both load (mmap) to the graph's neighbors, derived keys and "
              f"levels and levels_stats", flush=True)


def _host_builder(dev, ctx: dict) -> None:
    """9c: HNSWIndex.build(backend="host") on a slice of phase 4's
    library, searched on the card and on the host."""
    lib = ctx["library"]
    q = lib[HOST_N:HOST_N + 200]          # held out, the same library
    index = HNSWIndex(ndim=1024, connectivity=16, expansion_add=128,
                      device=dev)
    index.add(np.arange(HOST_N), lib[:HOST_N])
    t0 = time.perf_counter()
    g = index.build(backend="host")
    t_build = time.perf_counter() - t0
    _check_graph(g)
    ctx["host_graph"], ctx["host_build_s"] = g, t_build     # for 16b
    d_dev, _ = index.search(q, k=5, expansion_search=64)
    t0 = time.perf_counter()
    d_host, _ = search_hnsw(g, q, k=5, expansion_search=64)
    t_host = time.perf_counter() - t0
    gap = abs(float(np.mean(d_dev)) - float(np.mean(d_host)))
    check(gap < 0.02, f"9c: mean top-5 distance, card vs host, differs by "
          f"{gap:.4f} (>= 0.02)")
    _, truth = index.search(q, k=10, exact=True)
    _, found = index.search(q, k=10, expansion_search=128)
    recall = _recall(found, truth)
    check(recall >= 0.85, f"9c: recall@10 {recall:.4f} at ef 128 (< 0.85)")
    print(f"[9c host builder] {HOST_N:,} rows, M=16, expansion_add 128: "
          f"build {t_build:.1f} s on the host, layers {g.layer_sizes}; mean "
          f"top-5 distance {float(np.mean(d_dev)):.4f} on the card vs "
          f"{float(np.mean(d_host)):.4f} by search_hnsw ({t_host:.2f} s); "
          f"recall@10 {recall:.4f} at ef 128 against brute force",
          flush=True)


def _smiles(ctx: dict) -> None:
    """9d: the hashed fingerprints of N_SMILES of phase 4's store
    strings."""
    strings = list(ctx["store"].get_smiles_batch(range(N_SMILES)).values())
    t0 = time.perf_counter()
    a = smiles_fingerprints(strings)
    t1 = time.perf_counter()
    b = smiles_fingerprints(strings)
    t2 = time.perf_counter()
    check(a.shape == (N_SMILES, 32) and np.array_equal(a, b),
          "9d: smiles_fingerprints is not deterministic")
    check(np.array_equal(a[7], smiles_fingerprint(strings[7])),
          "9d: batch and single fingerprints differ")
    print(f"[9d smiles] {N_SMILES:,} strings ({strings[0]!r} ...): "
          f"{t1 - t0:.2f} s and {t2 - t1:.2f} s, equal", flush=True)


def phase_port_forms(dev, ctx: dict) -> None:
    t0 = time.perf_counter()
    _streamed_build(dev, ctx)
    _storage(ctx)
    _host_builder(dev, ctx)
    _smiles(ctx)
    print(f"[9 forms] {time.perf_counter() - t0:.1f} s", flush=True)


def _same_graph(a, b) -> bool:
    return (a.layer_sizes == b.layer_sizes
            and all(np.array_equal(np.asarray(getattr(a, f)),
                                   np.asarray(getattr(b, f)))
                    for f in ("keys", "levels", "packed"))
            and all(np.array_equal(x, y)
                    for x, y in zip(a.neighbors, b.neighbors)))


def _member_truth(lib: np.ndarray, qidx: np.ndarray, dev, what: str):
    """Top-10 library rows of the member queries ``lib[qidx]``: the
    blocked brute force (matrix kernel), its first ``TRUTH_SAMPLE``
    queries held to the plain ``bruteforce_topk``, as 6c holds them."""
    q = to_torch_packed(lib[qidx], dev)
    db = to_torch_packed(lib, dev)
    d, ids = bruteforce_topk_blocked(q, db, 10, block=1 << 14)
    d_plain, i_plain = bruteforce_topk(q[:TRUTH_SAMPLE], db, 10)
    check(torch.equal(d[:TRUTH_SAMPLE], d_plain)
          and torch.equal(ids[:TRUTH_SAMPLE], i_plain),
          f"{what}: the blocked brute force differs from the plain one on "
          f"its first {TRUTH_SAMPLE} queries")
    return ids.cpu().numpy()


def _index_recall(index, q, truth, ef: int) -> float:
    _, found = index.search(q, k=10, expansion_search=ef)
    return _recall(found, truth)


def _beam_build(dev, lib: np.ndarray) -> dict:
    """10a: HNSWIndex.build(backend="device") on BUILD_N rows, beside the
    exact build of the same rows."""
    base = lib[:BUILD_N]
    qidx = np.random.default_rng(99).choice(BUILD_N, 512, replace=False)
    truth = _member_truth(base, qidx, dev, "10a")
    index = HNSWIndex(ndim=1024, connectivity=16, expansion_add=200,
                      device=dev)
    index.add(np.arange(BUILD_N), base)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = index.build(backend="device", batch_size=1024)
    t_build = time.perf_counter() - t0
    _check_graph(g)
    batches = -(-(BUILD_N - 1) // 1024)
    degree = float((g.neighbors[0] >= 0).sum(1).mean())
    recall = _index_recall(index, base[qidx], truth, 128)

    exact_index = HNSWIndex(ndim=1024, connectivity=16, device=dev)
    exact_index.add(np.arange(BUILD_N), base)
    t0 = time.perf_counter()
    exact_index.build(backend="exact")
    t_exact = time.perf_counter() - t0
    recall_exact = _index_recall(exact_index, base[qidx], truth, 128)
    print(f"[10a beam build] {BUILD_N:,} x 1024-bit, M=16, expansion_add "
          f"200, batch 1024, layers {g.layer_sizes}: {t_build:.1f} s, "
          f"{batches} batches, {t_build / batches:.3f} s a batch, layer-0 "
          f"mean degree {degree:.2f}; recall@10 at ef 128 over 512 member "
          f"queries {recall:.4f} (exact build {recall_exact:.4f}, "
          f"{t_exact:.1f} s)", flush=True)
    check(recall >= 0.80, f"10a: beam-built recall@10 {recall:.4f} < 0.80")
    check(recall >= recall_exact - 0.05, f"10a: beam-built recall@10 "
          f"{recall:.4f} more than 0.05 below the exact build's "
          f"{recall_exact:.4f}")
    return dict(index=index, exact_index=exact_index, recall=recall)


def _beam_parity(dev, lib: np.ndarray) -> None:
    """10b: the beam builder and the incremental insert on the card and
    on the CPU, dense and hashed visited sets: edge-identical."""
    kw = dict(connectivity=16, expansion_add=200, seed=0,
              batch_size=PARITY_BATCH)
    new = lib[PARITY_N:PARITY_N + PARITY_INSERT]
    budget = visited.DENSE_VISITED_BUDGET
    t_cpu = 0.0
    try:
        for hashed in (False, True):
            visited.DENSE_VISITED_BUDGET = 0 if hashed else budget
            t0 = time.perf_counter()
            cpu = build_hnsw_device(lib[:PARITY_N], device="cpu", **kw)
            cpu_ins = insert_into_graph(cpu, new, expansion_add=200,
                                        batch_size=PARITY_BATCH,
                                        device="cpu")
            t_cpu += time.perf_counter() - t0
            gpu = build_hnsw_device(lib[:PARITY_N], device=dev, **kw)
            gpu_ins = insert_into_graph(gpu, new, expansion_add=200,
                                        batch_size=PARITY_BATCH, device=dev)
            what = "hashed" if hashed else "dense"
            check(_same_graph(cpu, gpu), f"10b: the {what} beam build on "
                  f"the card differs from the CPU's")
            check(_same_graph(cpu_ins, gpu_ins), f"10b: the {what} insert "
                  f"on the card differs from the CPU's")
    finally:
        visited.DENSE_VISITED_BUDGET = budget
    print(f"[10b beam parity] {PARITY_N:,} rows (M=16, expansion_add 200, "
          f"batch {PARITY_BATCH}) and {PARITY_INSERT} inserted, dense and "
          f"hashed visited sets: card and CPU edge-identical on every layer "
          f"(CPU sides {t_cpu:.1f} s)", flush=True)


def _insert(dev, lib: np.ndarray, ctx: dict) -> None:
    """10c: HNSWIndex.insert of INSERT_N rows into 10a's graph."""
    index = ctx["index"]
    new_keys = np.arange(BUILD_N, BUILD_N + INSERT_N)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.insert(new_keys, lib[BUILD_N:], batch_size=1024)
    t_ins = time.perf_counter() - t0
    g = index.graph
    _check_graph(g)
    check(len(g) == BUILD_N + INSERT_N, f"10c: {len(g)} rows after insert")
    probe_rows = BUILD_N + np.random.default_rng(5).choice(
        INSERT_N, 512, replace=False)
    d, _ = index.search(lib[probe_rows], k=1)
    check(bool((d[:, 0] == 0).all()), f"10c: {int((d[:, 0] > 0).sum())} of "
          f"512 inserted rows not found at distance 0")
    n = BUILD_N + INSERT_N
    qidx = np.random.default_rng(99).choice(n, 512, replace=False)
    truth = _member_truth(lib, qidx, dev, "10c")
    recall = _index_recall(index, lib[qidx], truth, 128)
    print(f"[10c insert] {INSERT_N:,} rows into 10a's graph (batch 1024): "
          f"{t_ins:.1f} s ({INSERT_N / t_ins:,.0f} rows/s), layers "
          f"{g.layer_sizes}; 512 inserted rows found at distance 0; "
          f"recall@10 at ef 128 over 512 member queries of {n:,} "
          f"{recall:.4f} (10a {ctx['recall']:.4f})", flush=True)
    check(recall >= ctx["recall"] - 0.05, f"10c: recall@10 {recall:.4f} "
          f"more than 0.05 below 10a's {ctx['recall']:.4f}")


def _partitioned(dev, lib: np.ndarray, ctx: dict) -> None:
    """10d: build_hnsw_partitioned, 4 exact shards, against 10a's exact
    monolithic build, the launches of both Tanimoto kernels counted over
    it alone; then a small one on the card and on the CPU."""
    base = lib[:BUILD_N]
    kw = dict(n_shards=4, connectivity=16, expansion_add=128, seed=0,
              builder="exact")
    stage = {}
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = build_hnsw_partitioned(base, device=dev, stage_times=stage, **kw)
    t_build = time.perf_counter() - t0
    launches = _counts("tanimoto_bucket_topk", "tanimoto_matrix")
    _check_graph(g)
    for name, count in launches.items():
        check(count > 0, f"{name} never launched in the partitioned build")
    qidx = np.random.default_rng(99).choice(BUILD_N, 256, replace=False)
    truth = _member_truth(base, qidx, dev, "10d")
    recall = _index_recall(HNSWIndex.from_graph(g, device=dev), base[qidx],
                           truth, 64)
    recall_mono = _index_recall(ctx["exact_index"], base[qidx], truth, 64)
    print(f"[10d partitioned] {BUILD_N:,} rows, 4 exact shards, M=16, "
          f"expansion_add 128, layers {g.layer_sizes}: {t_build:.1f} s "
          f"(sub-builds {stage['sub_builds']:.2f} s, layer-0 stitch "
          f"searches {stage['stitch_search']:.2f} s, merge "
          f"{stage['merge']:.2f} s, layer >= 1 stitch "
          f"{stage['stitch_upper']:.2f} s); recall@10 at ef 64 over 256 "
          f"member queries {recall:.4f} (exact monolithic "
          f"{recall_mono:.4f}); launches {launches}", flush=True)
    check(recall >= recall_mono - 0.05, f"10d: partitioned recall@10 "
          f"{recall:.4f} more than 0.05 below the monolithic "
          f"{recall_mono:.4f}")
    check(recall >= 0.9, f"10d: partitioned recall@10 {recall:.4f} < 0.9")

    t0 = time.perf_counter()
    cpu = build_hnsw_partitioned(lib[:PART_PARITY_N], device="cpu", **kw)
    t_cpu = time.perf_counter() - t0
    gpu = build_hnsw_partitioned(lib[:PART_PARITY_N], device=dev, **kw)
    check(_same_graph(cpu, gpu), "10d: the partitioned build on the card "
          "differs from the CPU's")
    print(f"[10d partitioned parity] {PART_PARITY_N:,} rows, 4 exact "
          f"shards: card and CPU edge-identical on every layer (CPU "
          f"{t_cpu:.1f} s)", flush=True)


def phase_other_builders(dev) -> np.ndarray:
    """10: the other builders on the library of
    ``benchmarks/bench_build_device.py --library tree`` and
    ``bench_partition.py`` at their default 100,000 rows (1024 bits,
    M = 16): 10a the batched beam build against the exact build, 10b the
    beam build and insert on the card against the CPU, 10c the
    incremental insert of 10,000 more rows, 10d the partition-and-stitch
    build. The scale is cut from phase 4's 1M to those benchmarks' own
    100k: the beam builder is a host loop of small launches, and the
    phase has about 250 s of the run's 1200."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    lib, _ = make_library(BUILD_N + INSERT_N, 1024, seed=0)
    print(f"[10 library] {BUILD_N + INSERT_N:,} x 1024-bit (make_library, "
          f"seed 0): {time.perf_counter() - t0:.1f} s", flush=True)
    ctx = _beam_build(dev, lib)
    _beam_parity(dev, lib)
    _insert(dev, lib, ctx)
    _partitioned(dev, lib, ctx)
    print(f"[10 other builders] {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return lib


def _scoring32(true_scores):
    """Phase 4's scores rounded to float32, the device engine's score
    type: both engines then order the same values, so 11d compares orders
    and not roundings."""
    scores = true_scores.astype(np.float32)

    def scoring_fn(smiles: str) -> float:
        return float(scores[int(smiles[4:])])

    return scoring_fn, scores


def _held(mols, keys, scores, n: int, what: str) -> tuple:
    """Distinct ids, each with its own key's score, and the top-100
    recovery (held at 5x random, as phase 4 holds the device engine)."""
    ids = np.array([m[0] for m in mols])
    check(len(np.unique(ids)) == len(ids), f"{what}: duplicate ids")
    check(all(s == float(scores[keys[i]]) for i, s, _ in mols),
          f"{what}: a score is not its key's")
    true_top = set(np.argsort(scores, kind="stable")[:100].tolist())
    found = len(true_top & set(keys[ids].tolist()))
    random_expect = 100 * len(ids) / n
    check(found >= 5 * random_expect,
          f"{what}: top-100 recovery {found} < 5 x random "
          f"({random_expect:.2f})")
    return found, found / max(random_expect, 1e-9)


def _same_prefix(a, b, what: str) -> int:
    k = min(len(a), len(b))
    check(k > 0 and [(m[0], m[1]) for m in a[:k]]
          == [(m[0], m[1]) for m in b[:k]],
          f"{what}: orders differ over the common {k:,} molecules")
    return k


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _cli_build(dev, ctx: dict, tmp: str) -> str:
    """11a: the index CLI on CLI_N of phase 4's store strings, on the card,
    against the API build of the same fingerprints."""
    strings = ctx["store"].get_smiles_batch(range(CLI_N))
    path = os.path.join(tmp, "mols.smi")
    with open(path, "w") as f:
        f.writelines(f"{k}\t{s}\n" for k, s in strings.items())
    prefix = os.path.join(tmp, "lib")
    log = logging.getLogger("build_index")
    rec = _Records()
    log.addHandler(rec)
    _reset_counts()
    t0 = time.perf_counter()
    try:
        rc = build_index.main([path, "--out", prefix, "--ndim", "1024",
                               "--connectivity", "16"])
    finally:
        log.removeHandler(rec)
    t_cli = time.perf_counter() - t0
    launches = _counts("tanimoto_bucket_topk", "tanimoto_matrix")
    check(rc == 0, f"11a: build_index exited {rc}")
    check(os.path.exists(prefix + ".npz") and os.path.exists(prefix + ".db"),
          "11a: lib.npz or lib.db missing")
    for name, count in launches.items():
        check(count > 0, f"11a: {name} never launched by the index CLI")
    # the CLI logs its two stages' seconds
    secs = {r.msg.split()[0]: r.args[0 if r.msg.startswith("fing") else 1]
            for r in rec.records
            if r.msg.startswith(("fingerprinted in", "built HNSW"))}
    check(sorted(secs) == ["built", "fingerprinted"],
          f"11a: the CLI logged {[r.msg for r in rec.records]}")
    cli = HNSWGraph.load(prefix + ".npz")
    store = SQLiteSmilesStore(prefix + ".db")
    check(len(cli) == CLI_N and len(store) == CLI_N,
          f"11a: {len(cli)} nodes, {len(store)} SMILES rows")
    store.close()
    fps = smiles_fingerprints(list(strings.values()), n_bits=1024)
    api = HNSWIndex(ndim=1024, connectivity=16, expansion_add=400,
                    device=dev)
    api.add(np.fromiter(strings.keys(), np.int64), fps)
    check(_same_graph(cli, api.build()),
          "11a: the CLI's graph differs from HNSWIndex(...).build()")
    print(f"[11a index CLI] {CLI_N:,} strings -> {cli.layer_sizes}: "
          f"{t_cli:.2f} s (fingerprints {secs['fingerprinted']:.2f} s, "
          f"build {secs['built']:.2f} s on {dev}); launches {launches}; "
          f"edge-identical to HNSWIndex.build", flush=True)
    return prefix


def _host_run(t, n_to_score: int, what: str, **kw) -> tuple:
    """prime, traverse (termination checked every 20 ms, so the budget
    is overshot by 20 ms of scoring at most), the best 100; shut down."""
    t0 = time.perf_counter()
    t.prime()
    stats = t.traverse(n_to_score=n_to_score, poll_interval=0.02, **kw)
    best = t.get_best_molecules(100)
    secs = time.perf_counter() - t0
    mols = t.get_molecules()
    coord = t.get_traversal_stats()["coordination"]
    t.shutdown()
    check(len(best) == 100 and stats["n_scored"] >= n_to_score,
          f"{what}: {stats['n_scored']} scored of {n_to_score}")
    return mols, stats, coord, secs


def _distributed(ctx: dict, scoring_fn, scores) -> list:
    """11b: create_distributed_traverser on the 1M graph, 4 workers then
    1; returns the 1-worker order."""
    keys, n = ctx["keys"], len(ctx["keys"])
    for n_workers in (4, 1):
        t = create_distributed_traverser(ctx["index"], scoring_fn,
                                         smiles_store=ctx["store"],
                                         n_workers=n_workers)
        check(t.engine == "host", f"11b: engine {t.engine}")
        mols, stats, coord, secs = _host_run(t, HOST_TO_SCORE, "11b")
        found, times = _held(mols, keys, scores, n,
                             f"11b ({n_workers} workers)")
        print(f"[11b distributed] {n_workers} worker(s): {len(mols):,} "
              f"scored in {secs:.2f} s ({len(mols) / secs:,.0f} scored/s, "
              f"{stats['termination_reason']}); neighbor_fetch "
              f"{coord['neighbor_fetches']:,} x "
              f"{coord['avg_neighbor_fetch_ms']:.4f} ms; top-100 found "
              f"{found} ({times:.1f}x random)", flush=True)
    return mols


def _remote(ctx: dict, scoring_fn, scores, host1: list, tmp: str) -> None:
    """11c: the same graph served over loopback HTTP: a remote traversal
    with 1 worker, then a ScoringWorker joining the server's
    coordination."""
    graph, store, keys = ctx["graph"], ctx["store"], ctx["keys"]
    service = LocalHNSWService(graph, store)
    coord = CoordinationService(service, heartbeat_interval=0.5)
    srv, app = create_hnsw_server(graph, host="127.0.0.1", port=0,
                                  smiles_store=store, coordination=coord,
                                  cache_dir=tmp)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        t = create_remote_traverser(url, scoring_fn)
        check(t.engine == "host", f"11c: engine {t.engine}")
        mols, stats, cstats, secs = _host_run(t, HOST_TO_SCORE, "11c",
                                              n_workers=1)
        found, times = _held(mols, keys, scores, len(keys), "11c remote")
        k = _same_prefix(mols, host1, "11c remote vs 11b's 1 worker")
        q = app.metrics.latency_quantiles("/neighbors/{}/{}")
        print(f"[11c remote] 1 worker over {url}: {len(mols):,} scored in "
              f"{secs:.2f} s ({len(mols) / secs:,.0f} scored/s, "
              f"{stats['termination_reason']}); the order of 11b's over "
              f"{k:,}; neighbor_fetch {cstats['neighbor_fetches']:,} x "
              f"{cstats['avg_neighbor_fetch_ms']:.3f} ms on the client; "
              f"server /neighbors p50 {q[0.5]:.3f} ms, p99 {q[0.99]:.3f} "
              f"ms; top-100 found {found} ({times:.1f}x random)",
              flush=True)
        # the flow of examples/distributed_workers_example.py: the head
        # node primes its coordination, a worker elsewhere joins over HTTP
        top = service.get_top_level_nodes()
        lvl = max(0, graph.max_level - 1)
        for nid, smi in zip(top[0::2], top[1::2]):
            s = scoring_fn(smi)
            coord.scored_set.insert(nid, s, smi)
            if not coord.visited_set.checkAndInsert(nid, lvl):
                coord.priority_queue.insert(nid, lvl, s)
        coord.start()
        client = RemoteCoordinationClient(url, max_retries=1)
        worker = ScoringWorker(client, scoring_fn, poll_interval=0.01)
        t0 = time.perf_counter()
        worker.start()
        deadline = time.time() + 60
        done, reason = False, None
        while not done and time.time() < deadline:
            done, reason = coord.check_termination(n_to_score=REMOTE_N)
            time.sleep(0.05)
        worker.stop()
        client.shutdown()
        secs = time.perf_counter() - t0
        joined = coord.scored_set.get_molecules()
        wstats = coord.get_coordination_stats()["workers"][worker.worker_id]
        check(done and reason == "n_to_score" and len(joined) >= REMOTE_N,
              f"11c: the joining worker scored {len(joined)}")
        check(not worker.is_running and wstats["completed_count"]
              == worker.items_processed > 0,
              f"11c: worker {wstats} after stop")
        ids = [m[0] for m in joined]
        check(len(set(ids)) == len(ids) and all(
            s == float(scores[keys[i]]) for i, s, _ in joined),
            "11c: the joining worker's molecules")
        print(f"[11c worker] a ScoringWorker over RemoteCoordinationClient:"
              f" {worker.molecules_scored:,} scored, "
              f"{worker.items_processed:,} items in {secs:.2f} s, stopped",
              flush=True)
    finally:
        coord.shutdown()
        srv.shutdown()
        srv.server_close()


def _device_vs_host(dev, ctx: dict, scoring_fn, host1: list) -> None:
    """11d: the device engine at batch 1, one frontier level, against the
    host engine's 1-worker order."""
    t = RADTraverser(graph=ctx["graph"], scoring_fn=scoring_fn,
                     smiles_store=ctx["store"], engine="device",
                     batch_size=1, head_capacity=None, device=dev)
    t0 = time.perf_counter()
    t.prime()
    t.traverse(n_to_score=DEVICE_TO_SCORE)
    mols = t.get_molecules()
    secs = time.perf_counter() - t0
    t.shutdown()
    k = _same_prefix(mols, host1, "11d device engine at batch 1 vs host")
    check(k >= DEVICE_TO_SCORE, f"11d: {k} compared")
    print(f"[11d device vs host] batch 1: {len(mols):,} scored in "
          f"{secs:.2f} s; the host engine's order over {k:,}", flush=True)


def _nvidia_fds(pid: int) -> int:
    """Open /dev/nvidia* files of a process: a CUDA context holds some."""
    fd_dir = f"/proc/{pid}/fd"
    n = 0
    for fd in os.listdir(fd_dir):
        with contextlib.suppress(OSError):
            n += os.readlink(os.path.join(fd_dir, fd)).startswith(
                "/dev/nvidia")
    return n


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _server_process(args, tmp: str, name: str):
    """``python -m rad_tpu_torch.scripts.start_hnsw_server`` in its own
    process group, up on /health; the whole group is ended on exit."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO_ROOT, os.environ.get("PYTHONPATH")) if p))
    log = open(os.path.join(tmp, f"{name}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "rad_tpu_torch.scripts.start_hnsw_server",
         "--host", "127.0.0.1", "--port", str(port), "--cache-dir", tmp,
         *args], cwd=REPO_ROOT, env=env, stdout=log,
        stderr=subprocess.STDOUT, start_new_session=True)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 90
        while True:
            check(proc.poll() is None, f"11e: {name} exited {proc.returncode}")
            with contextlib.suppress(OSError):
                if _get(url + "/health")["status"] == "healthy":
                    break
            check(time.time() < deadline, f"11e: {name} not up in 90 s")
            time.sleep(0.2)
        yield proc, url
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=15)
        log.close()


def _server_cli(ctx: dict, scoring_fn, scores, prefix: str,
                tmp: str) -> None:
    """11e: the server CLI over 11a's files as users start it, then with
    two processes on one port; neither opens the card."""
    check(_nvidia_fds(os.getpid()) > 0,
          "11e: this process shows no /dev/nvidia file: the check is blind")
    t0 = time.perf_counter()
    with _server_process(["--hnsw-path", prefix + ".npz", "--database-path",
                          prefix + ".db", "--enable-coordination"], tmp,
                         "server") as (proc, url):
        t_up = time.perf_counter() - t0
        info = _get(url + "/info")
        check(info["hnsw"]["size"] == CLI_N and info["smiles_db_size"]
              == CLI_N, f"11e: /info {info['hnsw']}")
        t = create_remote_traverser(url, scoring_fn)
        mols, stats, _, secs = _host_run(t, REMOTE_N, "11e", n_workers=1)
        keys = np.asarray(HNSWGraph.load(prefix + ".npz").keys)
        ids = [m[0] for m in mols]
        check(len(set(ids)) == len(ids) and all(
            s == float(scores[keys[i]]) for i, s, _ in mols),
            "11e: the remote traversal's molecules")
        check(_nvidia_fds(proc.pid) == 0, "11e: the server opened the card")
    print(f"[11e server CLI] up in {t_up:.2f} s, /info {CLI_N:,} nodes; "
          f"remote traversal {len(mols):,} scored in {secs:.2f} s "
          f"({len(mols) / secs:,.0f} scored/s)", flush=True)
    with _server_process(["--hnsw-path", prefix + ".npz", "--database-path",
                          prefix + ".db", "--workers", "2"], tmp,
                         "workers") as (proc, url):
        pids = set()
        for _ in range(200):
            pids.add(_get(url + "/health")["pid"])
            if len(pids) == 2:
                break
        check(len(pids) == 2, f"11e: --workers 2 answered from {pids}")
        check(_get(url + "/neighbors/0/0")["node_id"] == 0,
              "11e: --workers 2 /neighbors")
        opened = {pid: _nvidia_fds(pid) for pid in pids | {proc.pid}}
        check(not any(opened.values()),
              f"11e: a server process opened the card: {opened}")
    print(f"[11e server CLI] --workers 2: pids {sorted(pids)} both answer; "
          f"no /dev/nvidia file open in {sorted(opened)}", flush=True)


def phase_deployment(dev, ctx: dict) -> None:
    """11: the deployment modes on phase 4's graph: the index CLI on the
    card, the distributed and remote host engine, the device engine
    against it, the server CLI."""
    t_phase = time.perf_counter()
    scoring_fn, scores = _scoring32(ctx["true_scores"])
    with tempfile.TemporaryDirectory() as tmp:
        prefix = _cli_build(dev, ctx, tmp)
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated(dev)
        host1 = _distributed(ctx, scoring_fn, scores)
        _remote(ctx, scoring_fn, scores, host1, tmp)
        mem1 = torch.cuda.memory_allocated(dev)
        check(mem1 == mem0, f"11b-c: the host engine allocated "
                            f"{mem1 - mem0} bytes on the card")
        _device_vs_host(dev, ctx, scoring_fn, host1)
        gc.collect()
        torch.cuda.synchronize()
        mem2 = torch.cuda.memory_allocated(dev)
        check(mem2 == mem0, f"11d: {mem2 - mem0} bytes left on the card")
        _server_cli(ctx, scoring_fn, scores, prefix, tmp)
    print(f"[11 deployment] {time.perf_counter() - t_phase:.1f} s; "
          f"torch.cuda.memory_allocated {mem0:,} bytes before 11b, after "
          f"11c and after 11d", flush=True)


def _scored_keys(traverser, keys) -> list:
    return [int(keys[m[0]]) for m in traverser.get_molecules()]


def _found(order_keys, top: set, budget: int) -> int:
    return len(top & set(order_keys[:budget]))


def phase_chemistry(dev) -> None:
    """12: the real-chemistry main path at the DUD-Z morgan example's size."""
    t0 = time.perf_counter()
    smiles, scores = make_smiles_library(CHEM_N, seed=0)
    t_lib = time.perf_counter() - t0
    t0 = time.perf_counter()
    fps = morgan_fingerprints_packed(smiles, radius=2, n_bits=1024)
    t_fp = time.perf_counter() - t0
    check(fps.shape == (CHEM_N, 32) and len({r.tobytes() for r in fps})
          > CHEM_N // 2, "12: degenerate Morgan fingerprints")

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = HNSWIndex(ndim=1024, connectivity=16, expansion_add=400,
                      device=dev)
    index.add(np.arange(CHEM_N), fps)
    index.build()
    t_build = time.perf_counter() - t0
    launches = _counts("tanimoto_bucket_topk", "tanimoto_matrix")
    for name, count in launches.items():
        check(count > 0, f"12: {name} never launched in the build")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dudez.rad.npz")
        index.save(path)
        with np.load(path) as z:
            meta = json.loads(z["meta_json"].tobytes().decode())
        check(meta.get("fp_format_version") == FP_FORMAT_VERSION,
              f"12: the saved graph stamps fp_format_version "
              f"{meta.get('fp_format_version')}, not {FP_FORMAT_VERSION}")
        loaded = HNSWIndex.load(path, device=dev)
    check(_same_graph(loaded.graph, index.graph), "12: save/load changed "
          "the graph")
    _check_graph(loaded.graph)

    table = {smi: float(sc) for smi, sc in zip(smiles, scores)}
    store = InMemorySmilesStore({i: smi for i, smi in enumerate(smiles)})
    traverser = create_local_traverser(loaded, lambda smi: table[smi],
                                       smiles_store=store, batch_size=4,
                                       n_score_threads=1)
    keys = np.asarray(loaded.graph.keys)
    top = set(np.argsort(scores, kind="stable")[:CHEM_TOP].tolist())
    t0 = time.perf_counter()
    traverser.prime()
    traverser.traverse(n_to_score=CHEM_N // 100)
    at1 = _found(_scored_keys(traverser, keys), top, CHEM_N // 100)
    traverser.traverse(n_to_score=CHEM_N // 10)
    best = traverser.get_best_molecules(100)
    t_trav = time.perf_counter() - t0
    order = _scored_keys(traverser, keys)
    traverser.shutdown()
    at10 = _found(order, top, CHEM_N // 10)
    check(len(order) >= CHEM_N // 10 and len(set(order)) == len(order),
          "12: the order log is short or holds a duplicate")
    check(all(np.isfinite(sc) and sc == np.float32(scores[keys[i]])
              for i, sc, _ in best), "12: best molecules carry wrong scores")
    random_at1 = CHEM_TOP * 0.01
    check(at1 >= 5 * random_at1, f"12: top-{CHEM_TOP} found {at1} at 1 % "
          f"(< 5 x random, {random_at1:.1f})")
    check(at10 > CHEM_TOP // 2, f"12: top-{CHEM_TOP} found {at10} at 10 % "
          f"(not > 50 %)")

    part = fps[:CHEM_PARITY_N]
    built = []
    for where in (dev, torch.device("cpu")):
        ix = HNSWIndex(ndim=1024, connectivity=16, expansion_add=400,
                       device=where)
        ix.add(np.arange(CHEM_PARITY_N), part)
        built.append(ix.build())
    check(_same_graph(*built), f"12: the first {CHEM_PARITY_N:,} rows "
          f"built on the card and on the CPU differ")
    print(f"[12 chemistry] {CHEM_N:,} SMILES (make_smiles_library, seed 0) "
          f"{t_lib:.1f} s, Morgan r2/1024 fingerprints {t_fp:.1f} s (one "
          f"process); HNSWIndex(M=16, efC=400) build {t_build:.2f} s, layers "
          f"{loaded.graph.layer_sizes}, fp_format_version "
          f"{FP_FORMAT_VERSION} stamped and read back; launches {launches}",
          flush=True)
    print(f"[12 chemistry] prime+traverse to 1 % then 10 %, batch 4: "
          f"{len(order):,} scored in {t_trav:.2f} s; top-{CHEM_TOP} found "
          f"{at1} at 1 % ({at1 / random_at1:.1f}x random), {at10} at 10 %; "
          f"the first {CHEM_PARITY_N:,} rows card = CPU", flush=True)


def _json_line(fn, *args, **kw) -> dict:
    """Run an entry point's ``main`` in this process; its last stdout
    line, a JSON object (stdout still printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args, **kw)
    out = buf.getvalue()
    sys.stdout.write(out)
    check(rc == 0, f"{fn.__module__}.main returned {rc}")
    return json.loads(out.strip().splitlines()[-1])


def phase_sweeps(dev, ctx10: dict) -> None:
    """13: the recall and probe-sweep entry points."""
    # 13a: bench_recall, the exact builder on the sequential tree library
    res = {}
    _reset_counts()
    t0 = time.perf_counter()
    rec = _json_line(bench_recall.main,
                     ["--n", str(RECALL_N), "--q", "256", "--efs", "32",
                      "128", "--builder", "exact", "--device", str(dev)],
                     result=res)
    t_recall = time.perf_counter() - t0
    launches = _counts("tanimoto_bucket_topk", "tanimoto_matrix")
    check(rec["builder"] == "exact" and [r["ef"] for r in rec["results"]]
          == [32, 128], f"13a: unexpected record {rec}")
    r128 = rec["results"][1]["recall"]
    check(r128 >= RECALL_BAR, f"13a: recall@10 at ef 128 {r128:.4f} < "
          f"{RECALL_BAR}")
    q = to_torch_packed(res["queries"][:TRUTH_SAMPLE], dev)
    db = to_torch_packed(np.asarray(res["graph"].packed), dev)
    _, plain = bruteforce_topk(q, db, 10)
    check(np.array_equal(plain.cpu().numpy(), res["truth"][:TRUTH_SAMPLE]),
          f"13a: bench_recall's truth differs from the plain "
          f"bruteforce_topk on its first {TRUTH_SAMPLE} queries")
    del q, db, res
    print(f"[13a bench_recall] {RECALL_N:,} tree rows, exact builder: "
          + "; ".join(f"ef {r['ef']} recall@10 {r['recall']:.4f}, "
                      f"{r['qps']:,.0f} q/s, {r['qps_chained']:,.0f} q/s "
                      f"chained" for r in rec["results"])
          + f"; {t_recall:.1f} s; truth = plain on {TRUTH_SAMPLE} queries; "
          f"launches {launches}", flush=True)

    # 13b: the sweep's evaluation of phase 6b's graph (the sweep's own
    # qblock:16 build) over phase 6's library: 6c's recalls
    _reset_counts()
    t0 = time.perf_counter()
    evaluate = bench_probe_sweep.RecallEval(
        ctx10["library"], bench_probe_sweep.member_queries(N10, 500),
        [32, 128], dev)
    got = evaluate(ctx10["graph"])
    t_eval = time.perf_counter() - t0
    launches = _counts("tanimoto_bucketmin", "tanimoto_matrix")
    want = ctx10["recall"]
    check(got["edge_recall_at_10"] == round(want["edge"], 4)
          and got["recall_at_10_ef32"] == want["ef32"]
          and got["recall_at_10_ef128"] == want["ef128"],
          f"13b: the sweep's recalls {got} differ from 6c's {want}")
    check(launches["tanimoto_matrix"] > 0, "13b: the truth never launched "
          "tanimoto_matrix")
    print(f"[13b probe sweep] RecallEval of 6b's 10M qblock:16 graph (seed "
          f"0): {got} = 6c's, truth taken anew; {t_eval:.1f} s; launches "
          f"{launches}", flush=True)
    del evaluate

    # 13c: the morgan library, the exact baseline and one probed point
    with tempfile.TemporaryDirectory() as tmp:
        _reset_counts()
        t0 = time.perf_counter()
        out = _json_line(bench_probe_sweep.main, [
            "--n", str(SWEEP_MORGAN_N), "--library", "morgan", "--csize",
            "4096", "--sweep", "exact:0,qblock:2", "--recall", "200",
            "--ef", "32,128", "--results", os.path.join(tmp, "r.jsonl"),
            "--cache-dir", tmp, "--device", str(dev)])
        t_sweep = time.perf_counter() - t0
        launches = _counts("tanimoto_bucketmin", "tanimoto_matrix")
        with open(os.path.join(tmp, "r.jsonl")) as f:
            lines = [json.loads(x) for x in f]
    check(out["metric"] == "probe_sweep" and out["n"] == SWEEP_MORGAN_N
          and out["results"] == lines and len(lines) == 2, f"13c: {out}")
    for r in lines:
        check(r["library"] == "morgan" and all(
            0 < r[k] <= 1 for k in ("edge_recall_at_10",
                                    "recall_at_10_ef32",
                                    "recall_at_10_ef128")),
              f"13c: bad record {r}")
    print(f"[13c morgan sweep] {SWEEP_MORGAN_N:,} molecules, csize 4096: "
          + "; ".join(f"{r['granularity']}:{r['probes']} build "
                      f"{r['build_s']} s, edge {r['edge_recall_at_10']}, "
                      f"ef 32 {r['recall_at_10_ef32']:.4f}, ef 128 "
                      f"{r['recall_at_10_ef128']:.4f}" for r in lines)
          + f"; {t_sweep:.1f} s; launches {launches}", flush=True)


def _scale_run(extra: list) -> dict:
    """bench_scale.main at 100M nodes; the record checked against its
    tensors."""
    base = torch.cuda.memory_allocated()
    res = {}
    rec = _json_line(bench_scale.main,
                     ["--n", str(SCALE_N), "--m", "8", "--batch", "1024",
                      "--budget", str(SCALE_BUDGET), "--runs", "1", *extra],
                     result=res)
    st = res["state"]
    log = tdev.read_order_log(st)
    what = " ".join(extra)
    check(all(r["n_scored"] >= SCALE_BUDGET
              for r in (rec["first_run"], *rec["runs"])),
          f"14 {what}: scored below the budget: {rec['runs']}")
    check(rec["order_log_distinct"] and len(np.unique(log)) == len(log)
          and len(log) == int(st.n_scored), f"14 {what}: the order log "
          f"holds a duplicate")
    held = (rec["graph_bytes"] + rec["score_source_bytes"]
            + sum(rec["state_bytes"].values()))
    peak = rec["peak_bytes"] - base
    check(abs(peak - held) <= PEAK_TOL * held, f"14 {what}: peak "
          f"{peak:,} bytes is not within {PEAK_TOL:.0%} of the {held:,} "
          f"bytes of its tensors")
    best = min(rec["runs"], key=lambda r: r["seconds"])
    print(f"[14 scale] {what}: {SCALE_N:,} nodes, m 8, batch 1024, budget "
          f"{SCALE_BUDGET:,}: {rec['value']:,.0f} scored/s "
          f"({best['n_scored']:,} in {best['seconds']:.2f} s, "
          f"{best['n_steps']} steps, {1e3 * rec['seconds_per_step']:.2f} ms "
          f"a step, dropped {best['n_dropped']}); peak {peak / 2**30:.3f} "
          f"GiB over the {held / 2**30:.3f} GiB of graph "
          f"({rec['graph_bytes']:,}), score source "
          f"({rec['score_source_bytes']:,}) and state (scores "
          f"{rec['state_bytes']['scores']:,} bytes)", flush=True)
    del res, st
    return rec


def phase_scale(dev) -> None:
    """14: the engine at 100M nodes, then one 200,000-node graph run in id
    mode on the CPU and on the card."""
    t0 = time.perf_counter()
    _scale_run(["--mode", "id", "--no-score-table"])
    _scale_run(["--mode", "hash"])
    t_runs = time.perf_counter() - t0

    dg, sizes = bench_scale.make_device_graph(SCALE_PARITY_N, 8, seed=0,
                                              device=dev)
    cpu = torch.device("cpu")
    host = dataclasses.replace(dg, adj=dg.adj.cpu(),
                               offsets=dg.offsets.cpu())
    logs = []
    for g in (dg, host):
        run, id_score = bench_scale.make_id_run(1024, True)
        st = tdev.init_state(g, score_table=False)
        top = torch.arange(sizes[-1] if sizes[-1] > 1 else sizes[-2],
                           dtype=torch.int32, device=g.device)
        st = run(tdev.prime(st, g, top, id_score(top)),
                 SCALE_PARITY_BUDGET, g)
        logs.append(tdev.read_order_log(st))
    check(np.array_equal(logs[0], logs[1]) and len(logs[0])
          >= SCALE_PARITY_BUDGET, "14: the id-mode order logs of one "
          "200,000-node graph differ between the card and the CPU")
    del dg, host
    print(f"[14 scale] 100M runs {t_runs:.1f} s; {SCALE_PARITY_N:,}-node "
          f"graph, id mode without the table, batch 1024: {len(logs[0]):,} "
          f"scored, the same order on the card and on {cpu}", flush=True)


POD_D = 4                  # phase 15: shards on the one card
POD_BATCH = 64
POD_T = 8                  # 15d: campaigns
POD_QUERIES, POD_EF = 500, 64
STREAM_N, STREAM_BUDGET = 10_000_000, 100_000


def _pod_mesh(dev, d: int, shape=None, axes=("graph",)):
    from rad_tpu_torch.parallel import make_mesh
    return make_mesh(shape or d, axis_names=axes, devices=[dev] * d)


def _pod_build(dev, ctx: dict, mesh) -> dict:
    """15a: the mesh build of phase 4's library, edge-identical to it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    stage = {}
    t0 = time.perf_counter()
    g = build_hnsw_exact(ctx["library"], keys=np.arange(N), connectivity=16,
                         seed=ctx["index"].seed, mesh=mesh,
                         stage_times=stage)
    dt = time.perf_counter() - t0
    launches = _counts("tanimoto_matrix", "tanimoto_bucket_topk")
    peak = torch.cuda.max_memory_allocated() - base
    check(_same_graph(g, ctx["graph"]), "15a: the mesh build is not "
          "edge-identical to phase 4's graph")
    check(launches["tanimoto_bucket_topk"] > 0, "15a: the bucket top-k "
          "never launched on the sharded build")
    s4 = ctx["stage"]
    print(f"[15a pod build] {N:,} x 1024-bit on {POD_D} shards: {dt:.2f} s "
          f"(candidates {stage['candidates']:.2f} s, selection "
          f"{stage['selection']:.2f} s, symmetrization "
          f"{stage['symmetrization']:.2f} s; phase 4: "
          f"{s4['candidates']:.2f} / {s4['selection']:.2f} / "
          f"{s4['symmetrization']:.2f} s); edge-identical to phase 4's "
          f"graph; peak allocated {peak / 2**30:.3f} GiB above the "
          f"{base / 2**30:.3f} GiB resident; launches {launches}",
          flush=True)
    return launches


def _pod_host(ctx: dict, mesh) -> None:
    """15b: the host-scored pod through the user entry point."""
    from rad_tpu_torch import create_pod_traverser
    scoring_fn, host_ids = ctx["scoring_fn"], [m[0] for m in ctx["mols"]]
    keys, true_scores = ctx["keys"], ctx["true_scores"]
    sets = []
    for depth in (1, 2):
        for shard_state in (False, True):
            t = create_pod_traverser(ctx["index"], scoring_fn, mesh=mesh,
                                     smiles_store=ctx["store"],
                                     batch_size=8, shard_state=shard_state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.prime()
            stats = t.traverse(n_to_score=N_TO_SCORE, pipeline_depth=depth)
            best = t.get_best_molecules(100)
            dt = time.perf_counter() - t0
            mols = t.get_molecules()
            t.shutdown()
            ids = [m[0] for m in mols]
            what = f"15b depth {depth} shard_state={shard_state}"
            check(stats["n_scored"] >= N_TO_SCORE and len(best) == 100,
                  f"{what}: short run")
            check(len(set(ids)) == len(ids), f"{what}: duplicate ids")
            check(all(s == np.float32(true_scores[keys[i]])
                      for i, s, _ in mols), f"{what}: a score is not its "
                  f"key's")
            if depth == 1:
                check(ids == host_ids, f"{what}: the order differs from "
                      f"phase 4's single-card host-scored run")
            else:
                sets.append(set(ids))
            print(f"[15b pod host] {what}: {stats['n_scored']:,} scored in "
                  f"{dt:.2f} s ({stats['n_scored'] / dt:,.0f} scored/s, "
                  f"{stats['steps']} steps, host scoring "
                  f"{stats['scoring_time']:.2f} s); "
                  + ("phase 4's order" if depth == 1 else
                     "no duplicate, every score its key's"), flush=True)
    check(sets[0] == sets[1], "15b: the depth-2 scored sets differ between "
          "the replicated and the split state")


def _pod_run(step, st, n_to_score: int, target, tpop) -> tuple:
    """A pod step looped as fused_run loops: (state, steps, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while True:
        n_scored, live = torch.stack([st.n_scored.long(),
                                      st.f_live.long()]).tolist()
        if n_scored >= n_to_score or live <= 0:
            break
        st = step(st, target, tpop)
        steps += 1
    torch.cuda.synchronize()
    return st, steps, time.perf_counter() - t0


def _launches_a_step(step_fn, n: int = 10) -> tuple:
    """Kernel launches and wall ms of one step, from a profiled window."""
    _, wall_ms, (_, _, calls, _) = profiling._profiled(
        lambda: [step_fn() for _ in range(n)])
    return calls.get("cudaLaunchKernel", 0) / n, wall_ms / n


def _pod_steps(dev, ctx: dict, mesh) -> dict:
    """15c: the device-scored pod step against fused_run."""
    import warnings

    from rad_tpu_torch.parallel import sharded as sh
    from rad_tpu_torch.parallel.pod import _padded_device_graph

    graph, dg, packed, pops = ctx["graph"], ctx["dg"], ctx["packed"], \
        ctx["pops"]
    n_top = ctx["n_top"]
    target, tpop = packed[TARGET], pops[TARGET]
    seeds = torch.arange(n_top, dtype=torch.int32, device=dev)
    seed_scores = tanimoto_rows_to_target(packed[:n_top], pops[:n_top],
                                          target, tpop)
    cap = tdev.auto_frontier_capacity(R)
    budget = N_TO_SCORE
    t0 = time.perf_counter()
    sg = sh.shard_graph(graph, mesh)
    torch.cuda.synchronize()
    t_shard = time.perf_counter() - t0

    def single(head):
        st = tdev.prime(tdev.init_state(dg, cap, head_capacity=head), dg,
                        seeds, seed_scores)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = tdev.fused_run(st, dg, packed, pops, target, tpop, budget,
                            batch=POD_BATCH)
        torch.cuda.synchronize()
        return st, time.perf_counter() - t0

    def pod(full: bool, traffic: bool = False, g=None):
        g = sg if g is None else g
        if full:
            pdg = _padded_device_graph(g)
            st = sh.init_state_sharded(g, mesh, cap)
            step = sh.make_sharded_step_full(g, mesh, POD_BATCH,
                                             traffic=traffic)
        else:
            pdg = g.device_graph()
            st = tdev.init_state(pdg, cap, head_capacity=None)
            step = sh.make_sharded_step(g, mesh, POD_BATCH, traffic=traffic)
        return tdev.prime(st, pdg, seeds, seed_scores), step

    ref, t_ref = single(None)
    want = tdev.state_to_reference_arrays(ref)
    for full in (False, True):
        st, step = pod(full)
        st, steps, dt = _pod_run(step, st, budget, target, tpop)
        got = sh.sharded_state_to_reference_arrays(st)
        for k in ("order_log", "n_dropped", "n_scored"):
            check(np.array_equal(got[k], want[k]),
                  f"15c full={full}: {k} differs from fused_run's")
        for k in ("scored", "scores"):
            check(np.array_equal(got[k][:N], want[k]),
                  f"15c full={full}: {k} differs from fused_run's")
        name = "make_sharded_step_full" if full else "make_sharded_step"
        print(f"[15c pod step] {name} D={POD_D} batch {POD_BATCH}: "
              f"{int(st.n_scored):,} scored in {steps} steps, {dt:.2f} s "
              f"({int(st.n_scored) / dt:,.0f} scored/s, "
              f"{dt / steps * 1e3:.3f} ms/step; fused_run "
              f"{t_ref / int(ref.n_steps) * 1e3:.3f} ms/step); order log, "
              f"scored set, scores and drops equal fused_run's", flush=True)
    # the two-level layout of phase 5 reaches the same state through the
    # pod step as through fused_run
    ref2, _ = single("auto")
    st = tdev.prime(tdev.init_state(sg.device_graph(), cap), sg.device_graph(),
                    seeds, seed_scores)
    st, _, _ = _pod_run(sh.make_sharded_step(sg, mesh, POD_BATCH), st, budget,
                        target, tpop)
    check(_states_equal(st, ref2), "15c: the two-level pod run differs "
          "from fused_run's")

    # launches and ms a step by D, beside the single-card step
    per = {}
    warm, _ = single(None)
    per["single"] = _launches_a_step(lambda: tdev.fused_step(
        warm, dg, packed, pops, target, tpop, POD_BATCH))
    for d in (1, 2, POD_D):
        m = mesh if d == POD_D else _pod_mesh(dev, d)
        g = sg if d == POD_D else sh.shard_graph(graph, m)
        st, step = pod(False, g=g) if d == POD_D else (
            tdev.prime(tdev.init_state(g.device_graph(), cap,
                                       head_capacity=None),
                       g.device_graph(), seeds, seed_scores),
            sh.make_sharded_step(g, m, POD_BATCH))
        st, _, _ = _pod_run(step, st, budget, target, tpop)
        holder = [st]

        def one():
            holder[0] = step(holder[0], target, tpop)
        per[d] = _launches_a_step(one)
        del g, st, holder
    st, step = pod(True)
    st, _, _ = _pod_run(step, st, budget, target, tpop)
    holder = [st]

    def one_full():
        holder[0] = step(holder[0], target, tpop)
    per[f"{POD_D} full"] = _launches_a_step(one_full)
    del st, holder
    line = "; ".join(f"{k}: {v[0]:.1f} launches, {v[1]:.3f} ms"
                     for k, v in per.items())
    print(f"[15c pod step] a step under the profiler (batch {POD_BATCH}, "
          f"10 steps past 1 %): {line}", flush=True)

    # synchronisations of a pod step
    st, step = pod(False)
    st, _, _ = _pod_run(step, st, budget, target, tpop)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(5):
                st = step(st, target, tpop)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    # traffic: the rows each shard served over the run
    meter = sh.TrafficMeter(POD_D)
    st, step = pod(False, traffic=True)
    while int(st.n_scored) < budget:
        st, tr = step(st, target, tpop)
        meter.add(tr)
    stats = meter.stats()
    print(f"[15c pod step] {syncs / 5:.1f} synchronisations a step "
          f"(set_sync_debug_mode, 5 steps; sharding {N:,} nodes took "
          f"{t_shard:.2f} s); traffic over {stats['steps']} steps: adjacency "
          f"rows {stats['adj_rows_per_shard']} (imbalance "
          f"{stats['adj_imbalance']:.3f}), fingerprint rows "
          f"{stats['fp_rows_per_shard']} (imbalance "
          f"{stats['fp_imbalance']:.3f})", flush=True)
    one, step1 = pod(False)
    return dict(sg=sg, one_step=tdev.state_to_reference_arrays(
        step1(one, target, tpop)), seeds=seeds, seed_scores=seed_scores,
        target=target, tpop=tpop, cap=cap)


def _pod_multi(dev, ctx: dict, mesh, sg) -> None:
    """15d: the sharded panel step; each campaign its solo pod run."""
    from rad_tpu_torch.parallel import sharded as sh
    packed, pops, n_top = ctx["packed"], ctx["pops"], ctx["n_top"]
    rows = torch.arange(POD_T, device=dev) * 7919 % N
    targets, t_pops = packed[rows], pops[rows]
    dg = sg.device_graph()
    ids = torch.arange(n_top, dtype=torch.int32, device=dev)
    seeds = torch.stack([tanimoto_rows_to_target(packed[:n_top],
                                                 pops[:n_top], t, tp)
                         for t, tp in zip(targets, t_pops)])
    cap = tdev.auto_frontier_capacity(R)
    states = multi.prime_multi(multi.init_multi(dg, POD_T, cap), dg, ids,
                               seeds)
    step = sh.make_sharded_step_multi(sg, mesh, POD_BATCH)
    budgets = np.full(POD_T, N_TO_SCORE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while bool(multi.multi_active_mask(states, N_TO_SCORE).any()):
        states = step(states, targets, t_pops, budgets)
        steps += 1
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    solo_step = sh.make_sharded_step(sg, mesh, POD_BATCH)
    for t in range(POD_T):
        st = tdev.prime(tdev.init_state(dg, cap, head_capacity=None), dg,
                        ids, seeds[t])
        st, _, _ = _pod_run(solo_step, st, N_TO_SCORE, targets[t], t_pops[t])
        check(_same_result(_campaign_result(multi.campaign_state(states, t)),
                           _campaign_result(st)),
              f"15d: campaign {t} differs from its solo pod run")
    total = int(states.n_scored.sum())
    print(f"[15d pod panel] {POD_T} Tanimoto campaigns, batch {POD_BATCH}, "
          f"{POD_D} shards: {total:,} scored in {steps} steps, {dt:.2f} s "
          f"({total / dt:,.0f} scored/s aggregate, {dt / steps * 1e3:.3f} "
          f"ms/step); every campaign equals its solo pod run", flush=True)


def _pod_search(dev, ctx: dict, mesh, sg) -> dict:
    """15e: the sharded searches and brute force against one card's."""
    from rad_tpu_torch.parallel import sharded as sh
    from rad_tpu_torch.search.knn import search_device
    graph = ctx["graph"]
    rng = np.random.default_rng(15)
    q = np.asarray(graph.packed)[rng.choice(N, POD_QUERIES, replace=False)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d1, i1 = sh.make_sharded_search(sg, mesh, 10, POD_EF, POD_QUERIES)(q)
    torch.cuda.synchronize()
    t_1d = time.perf_counter() - t0
    dr, ir = search_device(graph, q, k=10, expansion_search=POD_EF,
                           expand_width=1, device=dev)
    check(torch.equal(d1, dr) and torch.equal(i1, ir), "15e: the 1-D "
          "sharded search differs from search_device")
    m2 = _pod_mesh(dev, 4, (2, 2), ("data", "graph"))
    sg2 = sh.shard_graph(graph, m2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d2, i2 = sh.make_sharded_search_2d(sg2, m2, 10, POD_EF, POD_QUERIES)(q)
    torch.cuda.synchronize()
    t_2d = time.perf_counter() - t0
    dr2, ir2 = search_device(graph, q, k=10, expansion_search=POD_EF,
                             expand_width=1, chunk_size=POD_QUERIES // 2,
                             device=dev)
    check(torch.equal(d2, dr2) and torch.equal(i2, ir2), "15e: the 2-D "
          "sharded search differs from search_device")
    del sg2
    _reset_counts()
    qb = to_torch_packed(q[:TRUTH_SAMPLE], dev)
    db, ib = sh.sharded_bruteforce_topk(sg, q[:TRUTH_SAMPLE], 10, mesh)
    launches = _counts("tanimoto_matrix", "tanimoto_bucketmin")
    dp, ip = bruteforce_topk(qb, ctx["packed"], 10)
    check(torch.equal(db, dp) and torch.equal(ib, ip), "15e: "
          "sharded_bruteforce_topk differs from bruteforce_topk")
    check(launches["tanimoto_matrix"] > 0, "15e: the matrix kernel never "
          "launched in the sharded brute force")
    print(f"[15e pod search] {POD_QUERIES} member queries, ef {POD_EF}: 1-D "
          f"{t_1d:.2f} s, (2, 2) {t_2d:.2f} s, ids and distances equal "
          f"search_device's; sharded_bruteforce_topk on {TRUTH_SAMPLE} "
          f"queries equal bruteforce_topk's (launches {launches})",
          flush=True)
    return launches


def _stream_rows(sizes: list, m: int, seed: int):
    """Host producers of a bench_scale-shaped random graph (its graph
    rule, in numpy) and random 1024-bit rows, seeded by the row range."""
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    m0 = 2 * m

    def adj(start, stop):
        rng = np.random.default_rng([seed, start])
        rows = np.arange(start, stop)
        lev = np.searchsorted(offsets, rows, side="right") - 1
        nl = np.asarray(sizes)[lev][:, None]
        ids = rng.integers(0, 1 << 31, (stop - start, m0)) % nl
        node = (rows - offsets[lev])[:, None]
        ids = np.where(ids == node, (ids + 1) % nl, ids)
        cap = np.where(lev == 0, m0, m)[:, None]
        return np.where((np.arange(m0)[None, :] < cap) & (nl > 1), ids,
                        -1).astype(np.int32)

    def fps(start, stop):
        rng = np.random.default_rng([seed + 1, start])
        return rng.integers(0, 1 << 32, (stop - start, 32), dtype=np.uint32)

    return adj, fps


def _pod_stream(dev, mesh) -> None:
    """15f: a 10M-node graph streamed into the shards, the pod step on it."""
    from rad_tpu_torch.parallel import sharded as sh
    sizes = bench_scale.hnsw_layer_sizes(STREAM_N, 8)
    adj, fps = _stream_rows(sizes, 8, seed=0)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sg = sh.shard_graph_streamed(mesh, n_nodes=STREAM_N, layer_sizes=sizes,
                                 m0=16, make_adj_rows=adj,
                                 make_packed_rows=fps)
    torch.cuda.synchronize()
    t_place = time.perf_counter() - t0
    dg = sg.device_graph()
    cap = tdev.auto_frontier_capacity(sg.n_rows)
    st = tdev.init_state(dg, cap)
    target = sg.packed[torch.tensor([7], device=dev)][0]
    tpop = popcount_rows(target[None, :])[0]
    top = sizes[-1] if sizes[-1] > 1 else sizes[-2]
    ids = torch.arange(top, dtype=torch.int32, device=dev)
    rows = sg.packed[ids.long()]
    st = tdev.prime(st, dg, ids, tanimoto_rows_to_target(
        rows, popcount_rows(rows), target, tpop))
    st, steps, dt = _pod_run(sh.make_sharded_step(sg, mesh, POD_BATCH), st,
                             STREAM_BUDGET, target, tpop)
    peak = torch.cuda.max_memory_allocated() - base
    held = sg.nbytes() + sum(
        t.numel() * t.element_size() for t in vars(st).values())
    log = tdev.read_order_log(st)
    check(int(st.n_scored) >= STREAM_BUDGET and len(np.unique(log))
          == len(log), "15f: short run or a duplicate in the order log")
    check(peak <= (1 + PEAK_TOL) * held, f"15f: peak {peak:,} bytes is not "
          f"within {PEAK_TOL:.0%} of the {held:,} bytes of its tensors")
    print(f"[15f pod stream] {STREAM_N:,} nodes, layers {sizes}, streamed "
          f"into {POD_D} shards in {t_place:.1f} s; pod step batch "
          f"{POD_BATCH}: {int(st.n_scored):,} scored in {steps} steps, "
          f"{dt:.2f} s ({int(st.n_scored) / dt:,.0f} scored/s, "
          f"{dt / steps * 1e3:.3f} ms/step); peak {peak / 2**30:.3f} GiB "
          f"over the {held / 2**30:.3f} GiB of graph and state", flush=True)


def _pod_multihost(dev, ctx: dict, ctx15: dict) -> None:
    """15g: initialize_multihost at world size 1 over NCCL, then one
    sharded step on the global mesh: 15c's state after one step."""
    import torch.distributed as dist

    from rad_tpu_torch.parallel import sharded as sh
    from rad_tpu_torch.parallel.multihost import (global_mesh,
                                                  initialize_multihost)
    initialize_multihost(f"127.0.0.1:{_free_port()}", num_processes=1,
                         process_id=0)
    try:
        check(dist.get_backend() == "nccl", "15g: the group is not NCCL")
        mesh = global_mesh()
        sg = sh.shard_graph(ctx["graph"], mesh)
        dg = sg.device_graph()
        st = tdev.prime(tdev.init_state(dg, ctx15["cap"], head_capacity=None),
                        dg, ctx15["seeds"], ctx15["seed_scores"])
        st = sh.make_sharded_step(sg, mesh, POD_BATCH)(
            st, ctx15["target"], ctx15["tpop"])
        got = tdev.state_to_reference_arrays(st)
        want = ctx15["one_step"]
        check(all(np.array_equal(got[k], want[k]) for k in want),
              "15g: the NCCL mesh's step differs from 15c's")
        print(f"[15g multihost] NCCL world size {dist.get_world_size()}, "
              f"global mesh {mesh.shape}: one sharded step equals 15c's "
              f"state", flush=True)
    finally:
        dist.destroy_process_group()


def phase_pod(dev, ctx: dict) -> dict:
    """15: the multi-device layer, four shards on the one card; returns
    the launches of the two Tanimoto kernels on its paths."""
    t0 = time.perf_counter()
    mesh = _pod_mesh(dev, POD_D)
    launches = _pod_build(dev, ctx, mesh)
    _pod_host(ctx, mesh)
    ctx15 = _pod_steps(dev, ctx, mesh)
    sg = ctx15.pop("sg")
    _pod_multi(dev, ctx, mesh, sg)
    for k, v in _pod_search(dev, ctx, mesh, sg).items():
        launches[k] = launches.get(k, 0) + v
    del sg
    _pod_stream(dev, mesh)
    _pod_multihost(dev, ctx, ctx15)
    print(f"[15 pod] phase 15 in {time.perf_counter() - t0:.1f} s; launches "
          f"of the Tanimoto kernels on its paths {launches}", flush=True)
    return launches


def _native_library() -> None:
    """16a: the native library compiled on this host (at its first use,
    9d's batch of fingerprints)."""
    t0 = time.perf_counter()
    ok = native.native_available()
    check(ok, f"16a: the native library did not build: {native._LIB_ERR}")
    info = native._INFO
    how = (f"compiled at first use by g++ "
           f"{info['isa'] or 'without an ISA flag'} in "
           f"{info['seconds']:.2f} s" if info["compiled"]
           else "found on disk")
    print(f"[16a native library] {how}; available in "
          f"{time.perf_counter() - t0:.3f} s; {info['path']}", flush=True)


def _native_parity(ctx: dict) -> None:
    """16b: the single-threaded native build of 9c's rows and settings,
    edge-identical to 9c's numpy host graph."""
    t0 = time.perf_counter()
    g = native.build_hnsw_native(ctx["library"][:HOST_N],
                                 keys=np.arange(HOST_N), connectivity=16,
                                 expansion_add=128, ndim=1024, seed=0,
                                 n_threads=1)
    t_native = time.perf_counter() - t0
    check(_same_graph(g, ctx["host_graph"]), "16b: the single-threaded "
          "native build differs from 9c's numpy host graph")
    print(f"[16b native = host] {HOST_N:,} rows, M=16, expansion_add 128, "
          f"one thread: {t_native:.3f} s against 9c's numpy "
          f"{ctx['host_build_s']:.1f} s ({ctx['host_build_s'] / t_native:,.0f}"
          f"x); edge-identical on every layer {g.layer_sizes}", flush=True)


def _native_index(dev, base: np.ndarray) -> tuple:
    """16c: HNSWIndex.build(backend="native") on every core; recall of
    the card's search and of the native search against the card's blocked
    brute force (the matrix kernel). Returns the queries, their truth and
    the matrix launches."""
    index = HNSWIndex(ndim=1024, connectivity=16, device=dev)
    index.add(np.arange(len(base)), base)
    t0 = time.perf_counter()
    g = index.build(backend="native")
    t_build = time.perf_counter() - t0
    _check_graph(g)
    qidx = np.random.default_rng(99).choice(len(base), NATIVE_Q,
                                            replace=False)
    q = base[qidx]
    _reset_counts()
    torch.cuda.synchronize()
    truth = _member_truth(base, qidx, dev, "16c")     # keys are row ids
    launches = _counts("tanimoto_matrix")
    check(launches["tanimoto_matrix"] > 0, "16c: the brute force never "
          "launched tanimoto_matrix")
    index.search(q, k=10, expansion_search=128)          # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, found = index.search(q, k=10, expansion_search=128)
    t_card = time.perf_counter() - t0
    recall = _recall(found, truth)
    check(recall >= NATIVE_RECALL_BAR, f"16c: recall@10 {recall:.4f} at ef "
          f"128 on the native graph (< {NATIVE_RECALL_BAR})")
    t0 = time.perf_counter()
    _, found_n = index.search(q, k=10, expansion_search=128,
                              backend="native")
    t_host = time.perf_counter() - t0
    recall_n = _recall(found_n, truth)
    check(recall_n >= NATIVE_SEARCH_BAR, f"16c: the native search's "
          f"recall@10 {recall_n:.4f} at ef 128 (< {NATIVE_SEARCH_BAR})")
    print(f"[16c native index] {len(base):,} rows, M=16, expansion_add 200, "
          f"{os.cpu_count()} host threads: build {t_build:.2f} s "
          f"({len(base) / t_build:,.0f} rows/s), layers {g.layer_sizes}; "
          f"{NATIVE_Q} member queries at ef 128: the card's search recall@10 "
          f"{recall:.4f}, {NATIVE_Q / t_card:,.0f} q/s; the native search "
          f"recall@10 {recall_n:.4f}, {NATIVE_Q / t_host:,.0f} q/s; truth by "
          f"the card's brute force, launches {launches}", flush=True)
    return q, truth, launches


def _native_fingerprints(ctx: dict) -> None:
    """16d: 11a's store strings through the native fingerprinter, the
    Python hash one by one and smiles_fingerprints; and the first
    FP_SINGLE_N through smiles_fingerprint, which tries RDKit's import
    for each string before it hashes."""
    strings = list(ctx["store"].get_smiles_batch(range(CLI_N)).values())
    t0 = time.perf_counter()
    a = native.smiles_fingerprints_native(strings)
    t1 = time.perf_counter()
    b = np.stack([pack_fingerprints(_hash_fingerprint_bits(s, 1024, 2))
                  for s in strings])
    t2 = time.perf_counter()
    c = smiles_fingerprints(strings)
    t3 = time.perf_counter()
    d = np.stack([smiles_fingerprint(s) for s in strings[:FP_SINGLE_N]])
    t4 = time.perf_counter()
    check(a.shape == (CLI_N, 32) and np.array_equal(a, b)
          and np.array_equal(a, c) and np.array_equal(a[:FP_SINGLE_N], d),
          "16d: native, Python and smiles_fingerprints fingerprints differ")
    print(f"[16d native fingerprints] {CLI_N:,} strings: native "
          f"{t1 - t0:.3f} s, the Python hash one by one {t2 - t1:.2f} s "
          f"({(t2 - t1) / (t1 - t0):,.0f}x), smiles_fingerprints "
          f"{t3 - t2:.3f} s; smiles_fingerprint one by one "
          f"{(t4 - t3) / len(d) * 1e3:.3f} ms a string over {len(d):,}; "
          f"array-equal", flush=True)


def _native_partitioned(dev, base: np.ndarray, q, truth) -> None:
    """16e: build_hnsw_partitioned(builder="auto") takes the native
    builder (no bucket launch: no exact shard) and meets 10d's bar."""
    check(partition._resolve_builder("auto", dev)
          is native.build_hnsw_native, "16e: 'auto' is not the native "
          "builder")
    stage = {}
    _reset_counts()
    t0 = time.perf_counter()
    g = build_hnsw_partitioned(base, n_shards=4, connectivity=16,
                               expansion_add=128, seed=0, builder="auto",
                               device=dev, stage_times=stage)
    t_build = time.perf_counter() - t0
    launches = _counts("tanimoto_bucketmin", "tanimoto_bucket_topk",
                       "tanimoto_matrix")
    _check_graph(g)
    check(launches["tanimoto_bucketmin"] == 0
          and launches["tanimoto_bucket_topk"] == 0, f"16e: an exact shard "
          f"build ran ({launches})")
    _, found = HNSWIndex.from_graph(g, device=dev).search(
        q, k=10, expansion_search=64)
    recall = _recall(found, truth)
    check(recall >= PART_RECALL_BAR, f"16e: partitioned recall@10 "
          f"{recall:.4f} at ef 64 (< {PART_RECALL_BAR})")
    print(f"[16e partitioned auto] {len(base):,} rows, 4 native shards, "
          f"M=16, expansion_add 128: {t_build:.2f} s (sub-builds "
          f"{stage['sub_builds']:.2f} s, layer-0 stitch searches "
          f"{stage['stitch_search']:.2f} s, merge {stage['merge']:.2f} s, "
          f"layer >= 1 stitch {stage['stitch_upper']:.2f} s), layers "
          f"{g.layer_sizes}; recall@10 at ef 64 {recall:.4f}; launches "
          f"{launches}", flush=True)


def phase_native(dev, ctx: dict, lib10: np.ndarray) -> dict:
    """16: the native host path on the card's host, over 9c's slice and
    graph, phase 10's library and 11a's strings; returns the launches of
    the matrix kernel by 16c's brute force."""
    t0 = time.perf_counter()
    _native_library()
    _native_parity(ctx)
    base = lib10[:BUILD_N]
    q, truth, launches = _native_index(dev, base)
    _native_fingerprints(ctx)
    _native_partitioned(dev, base, q, truth)
    print(f"[16 native] phase 16 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()
    try:
        smi = phase_device()
        timings = phase_kernels(dev)
        phase_build_parity(dev)
        launches, context = phase_main_path(dev, N, N_TO_SCORE)
        launches.update(phase_device_scored(dev, context))
        ctx10 = phase_probed_10m(dev)
        launches.update(phase_approx_1m(dev, context))
        phase_probed_parity(dev)
        nn_timings, nn_launches = phase_nn(dev)
        timings.update(nn_timings)
        launches.update(nn_launches)
        launches.update(phase_engine_variants(dev, context))
        phase_port_forms(dev, context)
        lib10 = phase_other_builders(dev)
        phase_deployment(dev, context)
        phase_chemistry(dev)
        phase_sweeps(dev, ctx10)
        del ctx10
        phase_scale(dev)
        pod_launches = phase_pod(dev, context)
        launches["tanimoto_matrix"] += phase_native(
            dev, context, lib10)["tanimoto_matrix"]
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.1f}"
          f" s", flush=True)
    print(smi)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=k["source"],
             replaces=k["replaces"], launches=launches[name],
             pod_launches=pod_launches.get(name, 0), **timings[name])
        for name, k in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
