"""Bit-packing of binary molecular fingerprints into 32-bit words.

Layout (identical to :mod:`rad_tpu.fp.pack`): bit ``j`` of a ``d``-bit
fingerprint lives in word ``j // 32`` at bit position ``j % 32``
(LSB-first). At the numpy boundary a fingerprint matrix is ``[N, W]
uint32`` with ``W = ceil(d / 32)``; inside torch the same words are held as
an ``int32`` bit-view (``packed.view(np.int32)``), because torch's uint32
supports too few operations.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

__all__ = [
    "packed_words",
    "pack_fingerprints",
    "unpack_fingerprints",
    "coerce_packed",
    "popcount",
    "popcount_rows",
    "popcount_rows_np",
    "random_fingerprints",
    "smiles_fingerprint",
    "smiles_fingerprints",
    "to_torch_packed",
]

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F
_H01 = 0x01010101


def packed_words(n_bits: int) -> int:
    """Number of 32-bit words needed for an ``n_bits``-bit fingerprint."""
    return (n_bits + 31) // 32


def pack_fingerprints(bits: np.ndarray) -> np.ndarray:
    """Pack a ``[N, d]`` 0/1 matrix into ``[N, ceil(d/32)] uint32``
    (LSB-first) — ``np.packbits(bitorder='little')`` viewed as
    little-endian words."""
    bits = np.asarray(bits)
    if bits.ndim == 1:
        return pack_fingerprints(bits[None, :])[0]
    n, d = bits.shape
    w = packed_words(d)
    if d % 32:
        padded = np.zeros((n, w * 32), dtype=np.uint8)
        padded[:, :d] = bits.astype(np.uint8) & 1
        bits = padded
    else:
        bits = np.ascontiguousarray(bits.astype(np.uint8) & 1)
    words = np.packbits(bits, axis=1, bitorder="little").view("<u4")
    return np.ascontiguousarray(words, dtype=np.uint32)


def coerce_packed(vectors: np.ndarray, n_bits: int) -> np.ndarray:
    """Normalize a fingerprint array to ``[N, W] uint32``.

    Accepts ``[N, n_bits/32]`` 32/64-bit integer words (passthrough),
    ``[N, n_bits]`` 0/1 bits (packed here), or ``[N, n_bits/8] uint8``
    ``np.packbits(bitorder='big')`` rows. 1-D inputs are one fingerprint.
    Raises ``ValueError`` for anything else.
    """
    vectors = np.asarray(vectors)
    if vectors.ndim == 1:
        return coerce_packed(vectors[None, :], n_bits)
    if vectors.ndim != 2:
        raise ValueError(f"expected a 2-D fingerprint array, got shape "
                         f"{vectors.shape}")
    w = packed_words(n_bits)
    cols = vectors.shape[1]
    if cols == w and vectors.dtype in (np.dtype(np.uint32),
                                       np.dtype(np.int32),
                                       np.dtype(np.uint64),
                                       np.dtype(np.int64)):
        return np.ascontiguousarray(vectors.astype(np.uint32, copy=False))
    if cols == n_bits:
        return pack_fingerprints(vectors)
    if cols == (n_bits + 7) // 8 and vectors.dtype == np.uint8:
        bits = np.unpackbits(vectors, axis=1, bitorder="big")[:, :n_bits]
        return pack_fingerprints(bits)
    raise ValueError(
        f"expected packed [N, {w}] uint32, [N, {n_bits}] bits, or "
        f"np.packbits [N, {(n_bits + 7) // 8}] uint8 rows; got shape "
        f"{vectors.shape} dtype {vectors.dtype}")


def unpack_fingerprints(packed: np.ndarray,
                        n_bits: int | None = None) -> np.ndarray:
    """Unpack ``[N, W] uint32`` back to a ``[N, n_bits]`` uint8 0/1
    matrix (all ``W * 32`` bits when ``n_bits`` is None)."""
    packed = np.asarray(packed, dtype=np.uint32)
    if packed.ndim == 1:
        return unpack_fingerprints(packed[None, :], n_bits)[0]
    n, w = packed.shape
    shifts = np.arange(32, dtype=np.uint32)
    bits = ((packed[:, :, None] >> shifts) & 1).astype(np.uint8).reshape(
        n, w * 32)
    if n_bits is not None:
        bits = bits[:, :n_bits]
    return bits


def to_torch_packed(packed: np.ndarray, device) -> torch.Tensor:
    """Upload ``[..., W] uint32`` words as their int32 bit-view on
    ``device``."""
    arr = np.ascontiguousarray(np.asarray(packed, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(device)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-element population count of 32-bit words (SWAR), as int32.

    ``x`` is an int32 (or int64) tensor holding 32-bit words. The words
    are widened to int64 and masked to 32 bits first, so no right shift
    ever sees a sign bit and the final byte-sum multiply cannot overflow.
    """
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return (((x * _H01) & 0xFFFFFFFF) >> 24).to(torch.int32)


def popcount_rows(packed: torch.Tensor) -> torch.Tensor:
    """Total set-bit count per row of a packed ``[..., W]`` tensor."""
    return popcount(packed).sum(dim=-1, dtype=torch.int32)


def popcount_rows_np(packed: np.ndarray) -> np.ndarray:
    """Host (numpy) row popcount of ``[..., W]`` 32-bit words."""
    packed = np.asarray(packed, dtype=np.uint32)
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(packed).sum(axis=-1, dtype=np.int32)
    lut = np.array([bin(i).count("1") for i in range(256)], dtype=np.int32)
    as_bytes = packed.view(np.uint8).reshape(*packed.shape[:-1], -1)
    return lut[as_bytes].sum(axis=-1, dtype=np.int32)


def random_fingerprints(
    n: int, n_bits: int = 1024, density: float = 0.1, seed: int = 0,
    chunk: int = 1 << 20,
) -> np.ndarray:
    """Random packed fingerprints ``[n, n_bits/32] uint32`` for tests and
    benchmarks — the same draws as ``rad_tpu.fp.random_fingerprints`` for
    equal arguments (never an all-zero row)."""
    rng = np.random.default_rng(seed)
    w = packed_words(n_bits)
    out = np.empty((n, w), dtype=np.uint32)
    thresh = np.uint8(int(density * 256))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        bits = (rng.integers(0, 256, size=(hi - lo, n_bits),
                             dtype=np.uint8) < thresh).astype(np.uint8)
        empty = bits.sum(axis=1) == 0
        if empty.any():
            bits[empty, rng.integers(0, n_bits, size=int(empty.sum()))] = 1
        out[lo:hi] = pack_fingerprints(bits)
    return out


def _fnv1a64(data: bytes) -> int:
    """FNV-1a, 64 bits: the hash of the fallback fingerprinter."""
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _hash_fingerprint_bits(smiles: str, n_bits: int,
                           radius: int = 2) -> np.ndarray:
    """The fingerprint used when RDKit is not importable: every byte
    substring of length 1 to ``2 * radius + 1`` of the SMILES string
    sets bit ``fnv1a64(substring) % n_bits`` (bit 0 when none is set).
    Deterministic across processes, and similar strings share bits;
    :func:`rad_tpu_torch.native.smiles_fingerprints_native` computes the
    same bits."""
    bits = np.zeros(n_bits, dtype=np.uint8)
    data = smiles.encode("utf-8")
    max_len = 2 * radius + 1
    for length in range(1, max_len + 1):
        for i in range(len(data) - length + 1):
            bits[_fnv1a64(data[i:i + length]) % n_bits] = 1
    if not bits.any():
        bits[0] = 1
    return bits


def smiles_fingerprint(smiles: str, n_bits: int = 1024,
                       radius: int = 2) -> np.ndarray:
    """Packed ``[W]`` uint32 fingerprint of one SMILES string: RDKit's
    Morgan fingerprint when ``rdkit`` is importable (and parses the
    string), else the hashed-substring fallback."""
    try:  # pragma: no cover - only where rdkit is installed
        from rdkit import Chem
        from rdkit.Chem import rdFingerprintGenerator

        mol = Chem.MolFromSmiles(smiles)
        if mol is not None:
            gen = rdFingerprintGenerator.GetMorganGenerator(radius=radius,
                                                            fpSize=n_bits)
            arr = np.zeros(n_bits, dtype=np.uint8)
            for b in gen.GetFingerprint(mol).GetOnBits():
                arr[b] = 1
            return pack_fingerprints(arr)
    except ImportError:
        pass
    return pack_fingerprints(_hash_fingerprint_bits(smiles, n_bits, radius))


def smiles_fingerprints(smiles: Sequence[str] | Iterable[str],
                        n_bits: int = 1024, radius: int = 2) -> np.ndarray:
    """Packed ``[N, W]`` uint32 fingerprints of a batch of SMILES strings,
    one :func:`smiles_fingerprint` each. Without RDKit, a batch of more
    than 64 strings goes to the multithreaded C++ fingerprinter
    (:func:`rad_tpu_torch.native.smiles_fingerprints_native`), which
    computes the same bits, as in ``rad_tpu``; only where its library
    does not compile does the batch stay in Python. An error inside the
    native call is raised, not swallowed."""
    smiles = list(smiles)
    if len(smiles) > 64 and not _has_rdkit():
        from rad_tpu_torch.native import (native_available,
                                          smiles_fingerprints_native)
        if native_available():
            return smiles_fingerprints_native(smiles, n_bits=n_bits,
                                              radius=radius)
    return np.stack([smiles_fingerprint(s, n_bits, radius)
                     for s in smiles])


def _has_rdkit() -> bool:
    try:
        import rdkit  # noqa: F401
    except ImportError:
        return False
    return True
