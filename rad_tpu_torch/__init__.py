"""rad_tpu_torch — RAD's main path in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The counterpart of :mod:`rad_tpu` (JAX/Pallas): packed-fingerprint
Tanimoto math, the exact all-pairs HNSW builder (and the numpy host
builder), ``.npz`` graph storage, the beam search, the score-guided
best-first traversal behind ``HNSWIndex`` / ``RADTraverser`` (the device
engine, and the host engine of the distributed and remote deployments),
the HNSW services and the HTTP index server. Module paths and public
names mirror ``rad_tpu`` so each piece has an obvious counterpart. This
package imports ``torch``, numpy and the standard library only — never
``jax`` and never ``rad_tpu`` (importing any ``rad_tpu`` module loads jax
through ``rad_tpu/__init__.py``).

Conventions:

* packed fingerprints live in torch as **int32 bit-views** of the uint32
  words (``np.ndarray.view(np.int32)``); the numpy boundary accepts and
  returns the uint32 layout ``rad_tpu`` uses;
* functions take an explicit ``device``; nothing sets a global default;
* randomness comes only from numpy generators seeded by the caller.

Top-level API (mirrors ``rad_tpu``):

    from rad_tpu_torch import HNSWIndex, create_local_traverser
"""

__version__ = "0.1.0"

__all__ = [
    "HNSWGraph",
    "HNSWIndex",
    "RADTraverser",
    "create_local_traverser",
    "create_distributed_traverser",
    "create_remote_traverser",
]

_LAZY = {
    "HNSWGraph": ("rad_tpu_torch.graph.storage", "HNSWGraph"),
    "HNSWIndex": ("rad_tpu_torch.api.index", "HNSWIndex"),
    "RADTraverser": ("rad_tpu_torch.api.traverser", "RADTraverser"),
    "create_local_traverser": ("rad_tpu_torch.api.factories",
                               "create_local_traverser"),
    "create_distributed_traverser": ("rad_tpu_torch.api.factories",
                                     "create_distributed_traverser"),
    "create_remote_traverser": ("rad_tpu_torch.api.factories",
                                "create_remote_traverser"),
}


def __getattr__(name):
    # lazy top-level API: `import rad_tpu_torch.fp` stays light
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'rad_tpu_torch' has no attribute {name!r}")
