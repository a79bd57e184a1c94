"""Packed binary fingerprints and Tanimoto distance (the metric layer).

Kernel wrappers live in :mod:`rad_tpu_torch.fp.kernels`; importing this
package builds nothing.
"""

from rad_tpu_torch.fp.pack import (
    coerce_packed,
    pack_fingerprints,
    packed_words,
    popcount,
    popcount_rows,
    popcount_rows_np,
    random_fingerprints,
    smiles_fingerprint,
    smiles_fingerprints,
    unpack_fingerprints,
)
from rad_tpu_torch.fp.tanimoto import (
    bruteforce_topk,
    tanimoto_distance,
    tanimoto_matrix,
    tanimoto_rows_to_target,
)

__all__ = [
    "coerce_packed",
    "pack_fingerprints",
    "packed_words",
    "popcount",
    "popcount_rows",
    "popcount_rows_np",
    "random_fingerprints",
    "smiles_fingerprint",
    "smiles_fingerprints",
    "unpack_fingerprints",
    "bruteforce_topk",
    "tanimoto_distance",
    "tanimoto_matrix",
    "tanimoto_rows_to_target",
]
