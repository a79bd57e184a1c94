"""rad_tpu_torch fingerprint math against rad_tpu (CPU, bit-equal).

The same seeded numpy inputs go through both packages; popcounts,
packing and every Tanimoto distance must agree bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rad_tpu.fp import pack as ref_pack
from rad_tpu.fp import tanimoto as ref_tani
from rad_tpu.fp.kernels import unpack_bitmajor as ref_unpack_bitmajor
from rad_tpu_torch.fp import pack, tanimoto
from rad_tpu_torch.fp.kernels import unpack_bitmajor


def _t(packed_u32):
    return pack.to_torch_packed(packed_u32, "cpu")


@pytest.fixture(scope="module")
def words():
    rng = np.random.default_rng(11)
    w = rng.integers(0, 1 << 32, size=(64, 8), dtype=np.uint64)
    w = w.astype(np.uint32)
    w[0] = 0xFFFFFFFF           # every bit, incl. the sign bit of int32
    w[1] = 0x80000000
    w[2] = 0
    return w


def test_popcount_bit_equal(words):
    ref = np.asarray(ref_pack.popcount(jnp.asarray(words)))
    out = pack.popcount(_t(words)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out.dtype == np.int32


def test_popcount_rows_bit_equal(words):
    ref = np.asarray(ref_pack.popcount_rows(jnp.asarray(words)))
    np.testing.assert_array_equal(pack.popcount_rows(_t(words)).numpy(), ref)
    np.testing.assert_array_equal(pack.popcount_rows_np(words),
                                  ref_pack.popcount_rows_np(words))


@pytest.mark.parametrize("n_bits", [64, 100, 256, 1024])
def test_pack_and_coerce_layouts(n_bits):
    rng = np.random.default_rng(n_bits)
    bits = (rng.random((17, n_bits)) < 0.2).astype(np.uint8)
    packed = pack.pack_fingerprints(bits)
    np.testing.assert_array_equal(packed, ref_pack.pack_fingerprints(bits))
    assert pack.packed_words(n_bits) == ref_pack.packed_words(n_bits)
    big_endian = np.packbits(bits, axis=1, bitorder="big")
    for layout in (packed, packed.view(np.int32), bits, big_endian):
        np.testing.assert_array_equal(
            pack.coerce_packed(layout, n_bits),
            ref_pack.coerce_packed(layout, n_bits))
    with pytest.raises(ValueError):
        pack.coerce_packed(np.zeros((3, 7), np.float32), n_bits)


def test_random_fingerprints_same_draws():
    np.testing.assert_array_equal(
        pack.random_fingerprints(300, n_bits=256, density=0.2, seed=4),
        ref_pack.random_fingerprints(300, n_bits=256, density=0.2, seed=4))


@pytest.fixture(scope="module")
def fps():
    a = ref_pack.random_fingerprints(48, n_bits=128, density=0.25, seed=8)
    b = ref_pack.random_fingerprints(80, n_bits=128, density=0.25, seed=9)
    a[3] = 0          # empty rows: union 0 counts as similarity 1
    b[5] = 0
    b[6] = a[7]       # exact duplicate: distance 0
    return a, b


def test_tanimoto_matrix_and_distance_bit_equal(fps):
    a, b = fps
    ref = np.asarray(ref_tani.tanimoto_matrix(jnp.asarray(a), jnp.asarray(b)))
    out = tanimoto.tanimoto_matrix(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out[3, 5] == 0.0 and out[7, 6] == 0.0
    ref_d = np.asarray(ref_tani.tanimoto_distance(jnp.asarray(a),
                                                  jnp.asarray(b[:48])))
    np.testing.assert_array_equal(
        tanimoto.tanimoto_distance(_t(a), _t(b[:48])).numpy(), ref_d)


def test_rows_to_target_bit_equal(fps):
    a, b = fps
    target = a[7]
    valid = np.arange(80) % 3 != 0
    ref = np.asarray(ref_tani.tanimoto_rows_to_target(
        jnp.asarray(b), ref_pack.popcount_rows(jnp.asarray(b)),
        jnp.asarray(target), ref_pack.popcount_rows(jnp.asarray(target)),
        valid=jnp.asarray(valid)))
    tb = _t(b)
    out = tanimoto.tanimoto_rows_to_target(
        tb, pack.popcount_rows(tb), _t(target),
        pack.popcount_rows(_t(target)), valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("block", [None, 7])
def test_bruteforce_topk_ties_to_smaller_id(fps, block):
    a, b = fps
    db = np.concatenate([b, b[:20]])       # duplicated rows tie exactly
    ref_d, ref_i = ref_tani.bruteforce_topk(jnp.asarray(a), jnp.asarray(db),
                                            12)
    d, i = tanimoto.bruteforce_topk(_t(a), _t(db), 12, block=block)
    np.testing.assert_array_equal(d.numpy(), np.asarray(ref_d))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))


def test_unpack_bitmajor_permutation(fps):
    a, _ = fps
    ref = np.asarray(ref_unpack_bitmajor(jnp.asarray(a), jnp.float32))
    np.testing.assert_array_equal(unpack_bitmajor(_t(a)).numpy(), ref)


@pytest.mark.parametrize("n_bits", [100, 128, None])
def test_unpack_fingerprints_bit_equal(n_bits):
    """tests/test_fp.py's round trip (17 x 100 bits) and whole words."""
    rng = np.random.default_rng(0)
    bits = (rng.random((17, 100)) < 0.3).astype(np.uint8)
    packed = pack.pack_fingerprints(bits)
    out = pack.unpack_fingerprints(packed, n_bits=n_bits)
    np.testing.assert_array_equal(
        out, ref_pack.unpack_fingerprints(packed, n_bits=n_bits))
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out[:, :100], bits)
    np.testing.assert_array_equal(pack.unpack_fingerprints(packed[3]),
                                  ref_pack.unpack_fingerprints(packed[3]))


def _smiles_batch(n: int):
    """SMILES-like strings of InMemorySmilesStore's kind, seeded."""
    rng = np.random.default_rng(n)
    alphabet = np.array(list("CNOSPFcno()=#123[]@H+-"))
    return [("C" + "".join(rng.choice(alphabet, size=rng.integers(4, 40))))
            for _ in range(n)]


@pytest.mark.parametrize("smiles,n_bits", [
    (["CCO", "CCN", "c1ccccc1"], 512), (["", "C", "CC(=O)O"], 1024),
    (_smiles_batch(96), 1024), (_smiles_batch(200), 256)],
    ids=["test_fp", "short", "batch96", "batch200"])
def test_smiles_fingerprints_bit_equal(smiles, n_bits):
    """The hashed fallback, string by string and in batches; past 64
    strings rad_tpu takes its C++ fingerprinter, so the larger batches also
    hold the port's loop to that."""
    out = pack.smiles_fingerprints(smiles, n_bits=n_bits)
    np.testing.assert_array_equal(
        out, ref_pack.smiles_fingerprints(smiles, n_bits=n_bits))
    assert out.shape == (len(smiles), n_bits // 32)
    assert out.dtype == np.uint32
    for s in smiles[:3]:
        np.testing.assert_array_equal(
            pack.smiles_fingerprint(s, n_bits=n_bits),
            ref_pack.smiles_fingerprint(s, n_bits=n_bits))
    assert ref_pack._fnv1a64(b"CCO") == pack._fnv1a64(b"CCO")


def test_unpack_to_dtype_and_mxu_matrix_match_reference():
    """tests/test_fp.py's MXU case: the matrix from unpacked operands is
    array-equal to the reference's and to the SWAR matrix."""
    f = ref_pack.random_fingerprints(64, n_bits=256, seed=5)
    f[9] = 0
    q, db = f[:8], f
    ref_u = ref_tani.unpack_to_dtype(jnp.asarray(q))
    ref_dbu = ref_tani.unpack_to_dtype(jnp.asarray(db))
    ref = np.asarray(ref_tani.tanimoto_matrix_mxu(
        ref_u, ref_dbu, ref_pack.popcount_rows(jnp.asarray(q)),
        ref_pack.popcount_rows(jnp.asarray(db))))
    qu = tanimoto.unpack_to_dtype(_t(q))
    dbu = tanimoto.unpack_to_dtype(_t(db))
    assert qu.dtype == torch.bfloat16 and qu.shape == (8, 256)
    np.testing.assert_array_equal(qu.float().numpy(),
                                  np.asarray(ref_u, np.float32))
    out = tanimoto.tanimoto_matrix_mxu(qu, dbu, pack.popcount_rows(_t(q)),
                                       pack.popcount_rows(_t(db)))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        out.numpy(), tanimoto.tanimoto_matrix(_t(q), _t(db)).numpy())


@pytest.mark.parametrize("n,k,block", [(500, 7, 128), (500, 12, 7),
                                       (130, 10, 1 << 16), (5, 8, 4)])
def test_bruteforce_topk_blocked_array_equal(fps, n, k, block):
    """Ragged last blocks, a block past N, and N < k (the result's tail
    keeps the initial (inf, -1) entries, as the reference's does)."""
    a, b = fps
    db = ref_pack.random_fingerprints(n, n_bits=128, seed=n)
    db[: min(n, 20)] = b[: min(n, 20)]
    db[-1] = a[0]
    q = np.concatenate([a[:6], db[:2]])
    ref_d, ref_i = ref_tani.bruteforce_topk_blocked(
        jnp.asarray(q), jnp.asarray(db), k, block=block)
    d, i = tanimoto.bruteforce_topk_blocked(_t(q), _t(db), k, block=block)
    assert d.shape == (len(q), k)
    np.testing.assert_array_equal(d.numpy(), np.asarray(ref_d))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    if n >= k:
        full_d, full_i = tanimoto.bruteforce_topk(_t(q), _t(db), k)
        np.testing.assert_array_equal(d.numpy(), full_d.numpy())
        np.testing.assert_array_equal(i.numpy(), full_i.numpy())
