"""The port's chemistry (``rad_tpu_torch.chem``, a copy of
``rad_tpu.chem``) against the original.

Each case of ``tests/test_chem.py`` runs on both packages: the port
passes the same assertions and every parse, invariant tuple and
fingerprint equals the original's. Then the library generator and the
packed Morgan fingerprints are bit-equal on 2,000 molecules at three
seeds, and the fingerprint format version is one number in both packages
and in the graphs the port saves.
"""

import dataclasses

import numpy as np
import pytest

import rad_tpu.chem as ref_chem
import rad_tpu.chem.library as ref_library
import rad_tpu.chem.morgan as ref_morgan
import rad_tpu_torch.chem as chem
import rad_tpu_torch.chem.library as library
import rad_tpu_torch.chem.morgan as morgan

PACKAGES = [pytest.param((ref_chem, ref_library, ref_morgan), id="rad_tpu"),
            pytest.param((chem, library, morgan), id="rad_tpu_torch")]


def _mol(m):
    """A parsed molecule as plain data, comparable across packages."""
    return ([dataclasses.astuple(a) for a in m.atoms], list(m.bonds))


def _same_parse(smi):
    assert _mol(chem.parse_smiles(smi)) == _mol(ref_chem.parse_smiles(smi))


def test_public_names_match():
    assert chem.__all__ == ["FP_FORMAT_VERSION", "SmilesError",
                            *ref_chem.__all__]
    assert morgan.__all__ == ref_morgan.__all__
    assert library.__all__ == ref_library.__all__
    assert library.SCAFFOLDS == ref_library.SCAFFOLDS
    assert library.SUBSTITUENTS == ref_library.SUBSTITUENTS
    assert library.LINKERS == ref_library.LINKERS
    assert issubclass(chem.SmilesError, ValueError)


def test_parse_basic_molecules():
    m = chem.parse_smiles("CCO")  # ethanol
    assert m.n_atoms == 3 and len(m.bonds) == 2
    assert [a.h_count for a in m.atoms] == [3, 2, 1]
    benzene = chem.parse_smiles("c1ccccc1")
    assert benzene.n_atoms == 6 and len(benzene.bonds) == 6
    assert all(a.aromatic and a.in_ring and a.h_count == 1
               for a in benzene.atoms)
    aspirin = chem.parse_smiles("CC(=O)Oc1ccccc1C(=O)O")
    assert aspirin.n_atoms == 13 and len(aspirin.bonds) == 13
    pyridine = chem.parse_smiles("c1ccncc1")
    assert next(a for a in pyridine.atoms if a.element == "N").h_count == 0
    charged = chem.parse_smiles("[N+](=O)[O-]")
    assert charged.atoms[0].charge == 1 and charged.atoms[2].charge == -1
    for smi in ("CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "c1ccncc1",
                "[N+](=O)[O-]", "[13CH4]", "C%12CC%12", "C/C=C\\C",
                "CC.O"):
        _same_parse(smi)


@pytest.mark.parametrize("bad", ["C(", "C)", "C1CC", "[Xx]", "C%1", ""])
def test_parse_errors(bad):
    with pytest.raises(chem.SmilesError) as got:
        chem.parse_smiles(bad)
    with pytest.raises(ref_morgan.SmilesError) as want:
        ref_chem.parse_smiles(bad)
    assert str(got.value) == str(want.value)


def test_ring_perception():
    for smi in ("C1CCCCC1", "C2CCCCC2"):
        assert all(a.in_ring for a in chem.parse_smiles(smi).atoms)
    tol = chem.parse_smiles("Cc1ccccc1")
    assert not tol.atoms[0].in_ring
    assert all(a.in_ring for a in tol.atoms[1:])
    bridge = chem.parse_smiles("c1ccccc1Cc1ccccc1").atoms[6]
    assert bridge.element == "C" and not bridge.in_ring
    for smi in ("C1CCCCC1", "Cc1ccccc1", "c1ccccc1Cc1ccccc1"):
        _same_parse(smi)


@pytest.mark.parametrize("a,b", [
    ("c1ccccc1C(=O)O", "OC(=O)c1ccccc1"),
    ("CC(=O)Oc1ccccc1C(=O)O", "OC(=O)c1ccccc1OC(C)=O"),
    ("C1CCCCC1", "C2CCCCC2"),
    ("CCO", "OCC"),
    ("c1ccc2ccccc2c1", "c1ccc2c(c1)cccc2"),
    ("CC(N)C(=O)O", "OC(=O)C(C)N"),
])
def test_fingerprint_writing_order_invariant(a, b):
    fa = chem.morgan_fingerprint(a)
    np.testing.assert_array_equal(fa, chem.morgan_fingerprint(b))
    np.testing.assert_array_equal(fa, ref_chem.morgan_fingerprint(a))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_similarity_is_chemical(pkg):
    c = pkg[0]

    def tan(x, y):
        fx, fy = c.morgan_fingerprint(x), c.morgan_fingerprint(y)
        return int((fx & fy).sum()) / int((fx | fy).sum())

    assert tan("CCO", "CCCO") > tan("CCO", "c1ccccc1")
    assert tan("CC(=O)Oc1ccccc1C(=O)O", "OC(=O)c1ccccc1O") > 0.3
    assert tan("c1ccncc1", "c1ccncc1") == 1.0


def test_radius_and_bits():
    for r in (0, 1, 2, 3):
        for n_bits in (64, 256, 1024, 2048):
            for smi in ("CCO", "CC(=O)Oc1ccccc1C(=O)O"):
                np.testing.assert_array_equal(
                    chem.morgan_fingerprint(smi, radius=r, n_bits=n_bits),
                    ref_chem.morgan_fingerprint(smi, radius=r,
                                                n_bits=n_bits))
    fp0 = chem.morgan_fingerprint("CCO", radius=0)
    assert chem.morgan_fingerprint("CCO", radius=2).sum() > fp0.sum()
    small = chem.morgan_fingerprint("CC(=O)Oc1ccccc1C(=O)O", n_bits=256)
    assert small.shape == (256,) and small.sum() > 0


def test_library_generates_unique_parseable_molecules():
    smiles, scores = library.make_smiles_library(3000, seed=4)
    ref_smiles, ref_scores = ref_library.make_smiles_library(3000, seed=4)
    assert smiles == ref_smiles
    np.testing.assert_array_equal(scores, ref_scores)
    assert len(smiles) == len(set(smiles)) == 3000
    assert np.isfinite(scores).all()
    for s in smiles[:300]:
        chem.parse_smiles(s)


def test_library_scores_follow_structure():
    smiles, scores = library.make_smiles_library(3000, seed=4)
    groups = {}
    for s, sc in zip(smiles, scores):
        groups.setdefault(s[:8], []).append(sc)
    within = np.mean([np.var(v) for v in groups.values() if len(v) > 10])
    assert within < np.var(scores), (within, np.var(scores))
    with pytest.raises(ValueError, match="exhausted") as got:
        _exhaust(library)
    with pytest.raises(ValueError) as want:
        _exhaust(ref_library)
    assert str(got.value) == str(want.value)


def _exhaust(lib):
    # one scaffold without sites and no linkers cannot give 2 molecules
    saved = lib.SCAFFOLDS
    lib.SCAFFOLDS = ("c1cnc2[nH]ccc2c1",)
    try:
        return lib.make_smiles_library(2, seed=0)
    finally:
        lib.SCAFFOLDS = saved


def test_packed_batch():
    smiles, _ = library.make_smiles_library(64, seed=1)
    packed = chem.morgan_fingerprints_packed(smiles, n_bits=512)
    assert packed.shape == (64, 16) and packed.dtype == np.uint32
    assert len({p.tobytes() for p in packed}) > 55
    np.testing.assert_array_equal(
        packed, ref_chem.morgan_fingerprints_packed(smiles, n_bits=512))


_C_AROM = (2, 2, 6, 0, 1, 1, 1)

GOLDEN_INVARIANTS = [
    ("methane", "C", [(0, 0, 6, 0, 4, 0, 0)]),
    ("water", "O", [(0, 0, 8, 0, 2, 0, 0)]),
    ("ethanol", "CCO", [(1, 1, 6, 0, 3, 0, 0), (2, 2, 6, 0, 2, 0, 0),
                        (1, 1, 8, 0, 1, 0, 0)]),
    ("ethene", "C=C", [(1, 2, 6, 0, 2, 0, 0)] * 2),
    ("acetylene", "C#C", [(1, 3, 6, 0, 1, 0, 0)] * 2),
    ("benzene", "c1ccccc1", [_C_AROM] * 6),
    ("pyridine", "c1ccncc1", [_C_AROM, _C_AROM, _C_AROM,
                              (2, 2, 7, 0, 0, 1, 1), _C_AROM, _C_AROM]),
    ("phenol", "Oc1ccccc1", [(1, 1, 8, 0, 1, 0, 0), (3, 3, 6, 0, 0, 1, 1),
                             _C_AROM, _C_AROM, _C_AROM, _C_AROM, _C_AROM]),
    ("acetic acid", "CC(=O)O", [(1, 1, 6, 0, 3, 0, 0), (3, 4, 6, 0, 0, 0, 0),
                                (1, 2, 8, 0, 0, 0, 0), (1, 1, 8, 0, 1, 0, 0)]),
    ("ammonium", "[NH4+]", [(0, 0, 7, 1, 4, 0, 0)]),
    ("acetate anion", "CC(=O)[O-]", [(1, 1, 6, 0, 3, 0, 0),
                                     (3, 4, 6, 0, 0, 0, 0),
                                     (1, 2, 8, 0, 0, 0, 0),
                                     (1, 1, 8, 255, 0, 0, 0)]),
    ("cyclohexane", "C1CCCCC1", [(2, 2, 6, 0, 2, 1, 0)] * 6),
]


def test_golden_invariants():
    for name, smi, expected in GOLDEN_INVARIANTS:
        got = chem.initial_invariant_tuples(chem.parse_smiles(smi))
        assert got == expected, name
        assert got == ref_chem.initial_invariant_tuples(
            ref_chem.parse_smiles(smi)), name


def test_golden_invariants_heteroaromatics():
    for smi, atom, want in (("c1ccsc1", 3, (2, 2, 16, 0, 0, 1, 1)),
                            ("c1cc[nH]c1", 3, (2, 2, 7, 0, 1, 1, 1)),
                            ("c1ccoc1", 3, (2, 2, 8, 0, 0, 1, 1))):
        got = chem.initial_invariant_tuples(chem.parse_smiles(smi))
        assert got[atom] == want, smi
        assert got == ref_chem.initial_invariant_tuples(
            ref_chem.parse_smiles(smi)), smi


def test_golden_distinct_environment_counts():
    cases = [("c1ccccc1", [1, 2, 3]), ("c1ccncc1", [2, 5, 9]),
             ("CCO", [3, 6, 6]), ("C", [1, 1, 1])]
    for smi, counts in cases:
        for r, want in enumerate(counts):
            fp = chem.morgan_fingerprint(smi, radius=r)
            assert int(fp.sum()) == want, (smi, r)
            np.testing.assert_array_equal(
                fp, ref_chem.morgan_fingerprint(smi, radius=r))


KEKULE_PAIRS = [
    ("benzene", "c1ccccc1", "C1=CC=CC=C1"),
    ("pyridine", "c1ccncc1", "C1=CC=NC=C1"),
    ("pyrrole", "c1cc[nH]c1", "C1=CC=CN1"),
    ("furan", "c1ccoc1", "C1=CC=CO1"),
    ("thiophene", "c1ccsc1", "C1=CC=CS1"),
    ("imidazole", "c1c[nH]cn1", "C1=CN=CN1"),
    ("naphthalene", "c1ccc2ccccc2c1", "C1=CC=C2C=CC=CC2=C1"),
    ("toluene", "Cc1ccccc1", "CC1=CC=CC=C1"),
    ("benzothiophene", "c1ccc2sccc2c1", "C1=CC=C2SC=CC2=C1"),
    ("styrene", "C=Cc1ccccc1", "C=CC1=CC=CC=C1"),
]


def test_kekulized_equals_aromatic():
    for name, arom, kek in KEKULE_PAIRS:
        fa = chem.morgan_fingerprint(arom)
        np.testing.assert_array_equal(fa, chem.morgan_fingerprint(kek),
                                      err_msg=name)
        np.testing.assert_array_equal(fa, ref_chem.morgan_fingerprint(kek),
                                      err_msg=name)
        _same_parse(kek)


def test_antiaromatic_and_saturated_not_perceived():
    for smi in ["C1=CC=CCC1", "O=C1C=CC(=O)C=C1", "C1CCCCC1", "C1=CC=C1"]:
        assert not any(a.aromatic for a in chem.parse_smiles(smi).atoms), smi
        _same_parse(smi)


def test_cross_conjugated_exocyclic_doubles_not_aromatic():
    for smi in ("C1=CC(=C2CCCCC2)C(=C2CCCCC2)C=C1",
                "C1=CC(C=C1)=C1C=CC=C1"):
        assert not any(a.aromatic for a in chem.parse_smiles(smi).atoms), smi
        _same_parse(smi)


def test_alternate_kekule_forms_agree():
    ref = chem.morgan_fingerprint("c1ccc2ccccc2c1")
    for kek in ["C1=CC=C2C=CC=CC2=C1", "C1=CC2=CC=CC=C2C=C1"]:
        np.testing.assert_array_equal(ref, chem.morgan_fingerprint(kek),
                                      err_msg=kek)
    ref3 = chem.morgan_fingerprint("c1ccc2cc3ccccc3cc2c1")
    kek3 = chem.morgan_fingerprint("C1=CC=C2C=C3C=CC=CC3=CC2=C1")
    np.testing.assert_array_equal(ref3, kek3)
    np.testing.assert_array_equal(
        kek3, ref_chem.morgan_fingerprint("C1=CC=C2C=C3C=CC=CC3=CC2=C1"))


def test_fused_ring_false_positive_is_kept():
    """The reference's fused-ring pi count (rad_tpu/chem/morgan.py:365)
    counts a double bond into an edge-fused sibling ring; the copy keeps
    the rule, so each perceives the same aromatic atoms on fused systems
    whose sibling ring is not aromatic."""
    for smi in ("C1=CC2=CCCCC2C=C1", "C1=CC2=CC=CCC2C=C1",
                "O=C1C=CC2=CC=CC=C2C1", "C1=CC2=C(C=C1)CCC=C2"):
        assert [a.aromatic for a in chem.parse_smiles(smi).atoms] == \
            [a.aromatic for a in ref_chem.parse_smiles(smi).atoms], smi
        np.testing.assert_array_equal(chem.morgan_fingerprint(smi),
                                      ref_chem.morgan_fingerprint(smi))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_library_fingerprints_bit_equal(seed):
    smiles, scores = library.make_smiles_library(2000, seed=seed)
    ref_smiles, ref_scores = ref_library.make_smiles_library(2000, seed=seed)
    assert smiles == ref_smiles
    np.testing.assert_array_equal(scores, ref_scores)
    got = chem.morgan_fingerprints_packed(smiles)
    assert got.shape == (2000, 32) and got.dtype == np.uint32
    np.testing.assert_array_equal(got,
                                  ref_chem.morgan_fingerprints_packed(smiles))


def test_format_version_is_one_number(tmp_path, caplog):
    import json
    import logging

    from rad_tpu.graph import storage as ref_storage
    from rad_tpu_torch.build.exact import build_hnsw_exact
    from rad_tpu_torch.graph import storage

    assert chem.FP_FORMAT_VERSION == ref_morgan.FP_FORMAT_VERSION
    assert storage.FP_FORMAT_VERSION is morgan.FP_FORMAT_VERSION
    smiles, _ = library.make_smiles_library(200, seed=0)
    g = build_hnsw_exact(chem.morgan_fingerprints_packed(smiles),
                         connectivity=8, device="cpu")
    path = str(tmp_path / "g.npz")
    g.save(path)
    with np.load(path) as z:
        meta = json.loads(z["meta_json"].tobytes().decode())
    assert meta["fp_format_version"] == ref_morgan.FP_FORMAT_VERSION
    # the reference loads it without a version warning
    with caplog.at_level(logging.WARNING):
        loaded = ref_storage.HNSWGraph.load(path, mmap=False)
    assert len(loaded) == 200
    assert not [r for r in caplog.records if "version" in r.getMessage()]
