"""The port's public signatures against rad_tpu's.

For every module that both packages hold, each public function, each
public class's ``__init__`` and public methods, must take the reference's
parameters: the same names, in the same order, with the same kinds and
defaults (``inspect.signature``; annotations aside). A package module must
export every name of the reference's ``__all__``, and so must the top-level
package (``""``); ``native`` is held both ways. The one difference
allowed everywhere is an extra ``device`` parameter: every entry point of
the port takes one. Every other difference is listed in
:data:`ALLOWED` with the diff it produces and its reason: a ROADMAP Queue 1
item by title, a form not ported by design (ROADMAP, "What not to carry
over"), or an internal laid out differently. A new gap fails here; so does
an entry whose gap has closed.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

SUBMODULES = [
    "api.factories", "api.index", "api.traverser",
    "build.device", "build.exact", "build.exact_sharded", "build.incremental",
    "build.partition", "build.probe", "build.reference",
    "chem.library", "chem.morgan",
    "fp.kernels", "fp.pack", "fp.tanimoto",
    "graph.adjpack", "graph.storage",
    "parallel.mesh", "parallel.multihost", "parallel.pod",
    "parallel.sharded",
    "search.knn", "search.visited",
    "server.http_server",
    "service.base", "service.local", "service.registry", "service.remote",
    "store.smiles_store",
    "traverse.coordinator", "traverse.device", "traverse.driver",
    "traverse.multi", "traverse.pipeline", "traverse.spill",
    "traverse.structures", "traverse.workers",
    "utils.profiling", "native",
]
# "" is the top-level package
PACKAGES = ["", "api", "build", "chem", "fp", "graph", "native", "parallel",
            "search", "server", "service", "store", "traverse", "utils"]
MODULES = SUBMODULES + [p for p in PACKAGES if p not in SUBMODULES]

NOT_PORTED = "not ported by design (ROADMAP, 'What not to carry over')"
LAYOUT = "an internal laid out differently"

# "module:name" -> (the diff it must produce, why)
ALLOWED = {
    # ---- names the port does not have
    **{f"fp:{name}": ("missing", LAYOUT + ": the kernel wrappers are "
                      "rad_tpu_torch.fp.kernels' tanimoto_matrix, "
                      "tanimoto_nn, tanimoto_bucketmin and "
                      "decode_bucket_keys, imported from there")
       for name in ("tanimoto_matrix_pallas", "tanimoto_nn_pallas",
                    "tanimoto_bucketmin_pallas", "decode_bucket_keys")},
    **{f"fp.kernels:{name}_pallas": (
        "missing", LAYOUT + f": the port's wrapper is {name}")
       for name in ("tanimoto_matrix", "tanimoto_nn", "tanimoto_bucketmin")},
    "search.knn:search_device_jit": (
        "missing", LAYOUT + ": the jitted batch is _search_batch, a host "
        "loop over a batch"),
    "graph.adjpack:adj_group_for": ("missing", NOT_PORTED),
    "graph.storage:HNSWGraph.device_put": ("missing", NOT_PORTED),
    "graph.storage:HNSWGraph.tree_flatten": ("missing", NOT_PORTED),
    "graph.storage:HNSWGraph.tree_unflatten": ("missing", NOT_PORTED),
    "traverse.device:DeviceGraph.tree_flatten": ("missing", NOT_PORTED),
    "traverse.device:DeviceGraph.tree_unflatten": ("missing", NOT_PORTED),
    "parallel.sharded:ShardedGraph.tree_flatten": ("missing", NOT_PORTED),
    "parallel.sharded:ShardedGraph.tree_unflatten": ("missing",
                                                     NOT_PORTED),
    "traverse.device:TraversalState.tree_flatten": ("missing", NOT_PORTED),
    "traverse.device:TraversalState.tree_unflatten": ("missing",
                                                      NOT_PORTED),
    "traverse.device:fused_run_segmented": ("missing", NOT_PORTED),
    "traverse.device:segmented_run": ("missing", NOT_PORTED),
    "traverse.device:expand_impl": ("missing", LAYOUT),
    "traverse.device:integrate_impl": ("missing", LAYOUT),
    "traverse.device:DenseStateOps.gather_enqueued": ("missing", LAYOUT),
    "traverse.device:DenseStateOps.gather_scored": ("missing", LAYOUT),
    "traverse.device:DenseStateOps.scatter_enqueued": ("missing", LAYOUT),
    "traverse.device:DenseStateOps.scatter_scored": ("missing", LAYOUT),
    "utils.profiling:aggregate_xla_ops": (
        "missing", LAYOUT + ": an XLA dump's reader; the port reads "
        "torch.profiler's as aggregate_device_ops"),
    # ---- signatures that differ
    "api.traverser:RADTraverser.__init__": (
        "extra head_capacity, order_log_spill, packed_adjacency",
        LAYOUT + ": the device engine's three options are named keywords "
        "where the reference pops them from **kwargs"),
    "build.exact:build_hnsw_exact": (
        "missing use_pallas, approx_recall, pairs_per_dispatch, "
        "interpret; extra stage_times, unported",
        NOT_PORTED + " (the Pallas knobs, the dispatch bound), refused "
        "through **unported; stage_times is the port's per-stage timer"),
    "build.exact_sharded:allpairs_topk_sharded": (
        "missing use_pallas, approx_recall, interpret, bucket_opts; extra "
        "pops, approx", NOT_PORTED + " (the Pallas knobs); " + LAYOUT
        + ": the popcounts come in beside the rows, as in the port's "
        "single-device stage, and approx is its bucket_approx"),
    "build.exact_sharded:probed_topk_sharded": (
        "missing scan_cols, use_pallas, approx_recall, interpret, "
        "bucket_opts; extra pops_cl, probe_tab, n_pad, approx, n_real",
        NOT_PORTED + " (the Pallas knobs); " + LAYOUT + ": the probe lists "
        "stay on the host (probe_tab) and the results are scattered to "
        "their rows' shards here (n_pad rows, n_real real)"),
    "build.exact_sharded:select_layer_sharded": (
        "missing mxu_pairs", NOT_PORTED + ": the port's selection has one "
        "pair-distance form"),
    "parallel.multihost:global_mesh": (
        "extra local_devices", LAYOUT + ": torch has no virtual CPU "
        "devices, so a CPU process names its own (default: its CUDA "
        "cards)"),
    "parallel.sharded:ShardedGraph.__init__": (
        "missing adj_group", NOT_PORTED + ": the port's packed adjacency "
        "is always group 1"),
    "build.partition:build_hnsw_partitioned": (
        "extra stage_times", "stage_times is the port's per-stage timer, "
        "as build_hnsw_exact's"),
    "build.probe:cluster_probes": ("missing use_pallas, interpret",
                                   NOT_PORTED),
    "build.probe:qblock_probes": ("missing use_pallas, interpret",
                                  NOT_PORTED),
    "fp.kernels:unpack_bitmajor": (
        "defaults dtype", LAYOUT + ": the default dtype is a torch dtype "
        "(float32) where the reference's is jnp.bfloat16"),
    "fp.tanimoto:bruteforce_topk": (
        "extra block", LAYOUT + ": the port's scan is blocked, "
        "the reference's one [B, N] matrix"),
    "search.visited:hashset_init": (
        "extra batch", LAYOUT + ": a batch of tables in one tensor, "
        "where the reference vmaps"),
    "traverse.device:DeviceGraph.__init__": (
        "missing adj_group; extra offsets_host",
        NOT_PORTED + " (adj_group); offsets_host is the host copy of the "
        "layer offsets, " + LAYOUT),
    "traverse.device:expand": (
        "missing refill",
        "refill lifts a decision out of a vmapped step, " + LAYOUT
        + " (the port's multi engine decides its refills itself)"),
    "traverse.device:integrate": (
        "missing commit", LAYOUT + ": commit picks one of the reference's "
        "frontier-commit programs; the port has one"),
    "traverse.device:make_device_run": (
        "extra fused_candidates",
        LAYOUT + ": the reference takes K1/K2 through its state ops"),
    "traverse.multi:multi_step": (
        "missing vm_expand_score, integrate_extra; extra score, gather_adj",
        LAYOUT + ": the hooks take the lane form: score(lanes, to_score) "
        "scores the active lanes where the reference vmaps an expand and "
        "score, and gather_adj is the adjacency hook the graph-sharded "
        "panel step needs (its state is replicated, so it forwards no "
        "state ops to integrate)"),
}


def _default(v):
    """A default's comparable form: dtypes of either package by name."""
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    if isinstance(v, type) and hasattr(v, "dtype"):
        return np.dtype(v).name          # jnp.bfloat16, np.float32, ...
    r = repr(v)
    return f"<{type(v).__name__}>" if " object at 0x" in r else r


def _params(obj):
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return [(p.name, p.kind.name,
             _default(p.default) if p.default is not p.empty else None)
            for p in sig.parameters.values()]


def _diff(ref, port) -> str:
    """The canonical difference of two parameter lists ("" if none)."""
    ref_names = [p[0] for p in ref]
    port = [p for p in port if p[0] in ref_names or p[0] != "device"]
    port_names = [p[0] for p in port]
    parts = []
    missing = [n for n in ref_names if n not in port_names]
    extra = [n for n in port_names if n not in ref_names]
    if missing:
        parts.append("missing " + ", ".join(missing))
    if extra:
        parts.append("extra " + ", ".join(extra))
    common = [n for n in ref_names if n in port_names]
    r, p = dict((x[0], x[1:]) for x in ref), dict((x[0], x[1:]) for x in port)
    kinds = [n for n in common if r[n][0] != p[n][0]]
    defaults = [n for n in common if r[n][1] != p[n][1]]
    if kinds:
        parts.append("kinds " + ", ".join(kinds))
    if defaults:
        parts.append("defaults " + ", ".join(defaults))
    if common != [n for n in port_names if n in common]:
        parts.append("order")
    return "; ".join(parts)


def _members(mod):
    """Public functions and classes defined in ``mod``, with each class's
    ``__init__`` and public methods: ``{qualname: object}``."""
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__",
                                           None) != mod.__name__:
            continue
        if callable(obj) and inspect.isfunction(inspect.unwrap(obj)):
            out[name] = inspect.unwrap(obj)     # jitted ones too
        elif inspect.isclass(obj):
            for mname, mobj in vars(obj).items():
                if mname.startswith("_") and mname != "__init__":
                    continue
                f = getattr(mobj, "__func__", mobj)
                if inspect.isfunction(f):
                    out[f"{name}.{mname}"] = f
    return out


def module_gaps(sub: str) -> dict:
    """``{"sub:name": diff}`` for every gap of one module pair."""
    ref = importlib.import_module(".".join(filter(None, ("rad_tpu", sub))))
    port = importlib.import_module(
        ".".join(filter(None, ("rad_tpu_torch", sub))))
    gaps = {}
    if sub in PACKAGES:
        for name in getattr(ref, "__all__", []):
            if not hasattr(port, name):
                gaps[f"{sub}:{name}"] = "missing"
        if sub not in SUBMODULES:
            return gaps
    ref_m, port_m = _members(ref), _members(port)
    for name, obj in ref_m.items():
        if name not in port_m:
            gaps[f"{sub}:{name}"] = "missing"
            continue
        a, b = _params(obj), _params(port_m[name])
        if a is not None and b is not None:
            d = _diff(a, b)
            if d:
                gaps[f"{sub}:{name}"] = d
    return gaps


@pytest.mark.parametrize("sub", MODULES)
def test_signatures_match_reference(sub):
    gaps = module_gaps(sub)
    listed = {k: v[0] for k, v in ALLOWED.items()
              if k.split(":")[0] == sub}
    new = {k: v for k, v in gaps.items() if listed.get(k) != v}
    closed = sorted(k for k in listed if k not in gaps)
    assert not new, f"gaps not in the allow-list (or changed): {new}"
    assert not closed, f"allow-list entries whose gap has closed: {closed}"


def test_allow_list_names_known_modules_and_reasons():
    for key, (diff, reason) in ALLOWED.items():
        assert key.split(":")[0] in MODULES, key
        assert diff and reason, key


def test_top_level_pod_traverser_is_lazy():
    """``rad_tpu_torch.PodTraverser`` is the pod module's class, as in the
    reference, and importing the package loads no ``parallel`` module."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, rad_tpu_torch\n"
            "assert not [m for m in sys.modules\n"
            "            if m.startswith('rad_tpu_torch.parallel')]\n"
            "from rad_tpu_torch.parallel.pod import PodTraverser\n"
            "assert rad_tpu_torch.PodTraverser is PodTraverser\n"
            "print('lazy')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "lazy" in proc.stdout
