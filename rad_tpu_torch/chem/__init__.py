"""Dependency-free chemistry: SMILES parsing + Morgan/ECFP fingerprints.

A copy of :mod:`rad_tpu.chem` (numpy only), so the port needs nothing of
the JAX package; ``tests/test_torch_chem.py`` holds it bit-equal to the
original. RAD's published workflow fingerprints with RDKit Morgan
r=2/1024-bit (the DUD-Z example notebook, cells ~92-118); this package
provides a self-contained equivalent that needs no RDKit:
a SMILES parser producing a molecular graph and the ECFP circular
fingerprint algorithm (Rogers & Hahn, J. Chem. Inf. Model. 2010) over it.
Bit positions differ from RDKit's (different hash), but the fingerprints
are real chemistry: canonical-form invariant, substructure-driven, and
Tanimoto-comparable.
"""

from rad_tpu_torch.chem.morgan import (
    FP_FORMAT_VERSION,
    SmilesError,
    MolGraph,
    initial_invariant_tuples,
    parse_smiles,
    morgan_fingerprint,
    morgan_fingerprints_packed,
)

__all__ = [
    "FP_FORMAT_VERSION",
    "SmilesError",
    "MolGraph",
    "initial_invariant_tuples",
    "parse_smiles",
    "morgan_fingerprint",
    "morgan_fingerprints_packed",
]
