"""tgt_torch's preparation of the real PCQM4Mv2 against tgt_tpu's (CPU).

Neither ogb nor rdkit is installed here, so both packages run against
fake ``ogb``, ``ogb.lsc``, ``ogb.utils``, ``ogb.utils.features``,
``rdkit``, ``rdkit.Chem`` and ``rdkit.Chem.AllChem`` modules, installed in
``sys.modules``, that read one raw fixture: 28 molecules of the port's
synthetic generator (train from a stand-in SDF with DFT coordinates and
explicit hydrogens on a few, valid and test-dev from stand-in SMILES, and a
test-challenge split that must be left out).

- ``prepare_pcqm4mv2`` and ``prepare_rdkit_coords`` of both packages write
  equal ``records.parquet``, ``dft_coords.parquet``, ``rdkit_coords.parquet``
  and ``splits.npz``, column by column, exactly; the rows read back through
  the port's dataset equal the source molecules after the structural
  transform;
- ``train3d_split`` (no sklearn) equals sklearn's ``train_test_split`` and
  tgt_tpu's at 3,378,606 / 78,606 and at small sizes;
- a misaligned SDF raises in both cores;
- every branch of ``mol_to_rdkit_coords`` and ``select_min_energy_conf``,
  in both packages;
- tgt_torch imports no sklearn, and ogb and rdkit only inside functions.
"""
import ast
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("pyarrow")

from tgt_tpu.data import prepare as jprepare
from tgt_torch.data import prepare
from tgt_torch.data.pcqm import Coords, PCQM4Mv2Dataset
from tgt_torch.data.structural import AddStructuralData
from tgt_torch.data.synthetic import make_molecule

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N_TRAIN, N_VALID, N_TEST, N_CHALLENGE = 16, 5, 4, 3
WITH_HS = (2, 5)          # train molecules stored with explicit hydrogens
EMBED_FAILS = (3, 17)     # fall back to Compute2DCoords
NO_CONFORMERS = (6,)      # MMFF returns nothing: the fallback as well
DUMMY = 9                 # a leading dummy atom: zero coordinates
PACKAGES = {"tgt_torch": prepare, "tgt_tpu": jprepare}


# -- the raw fixture and the fake toolkits ---------------------------------

def raw_molecules():
    """The fixture's molecules, by OGB index: a synthetic molecule each,
    its atomic numbers (6, or 0 first for the dummy) and for ``WITH_HS``
    two hydrogens bonded to atom 0 at the end."""
    rs = np.random.RandomState(5)
    mols = []
    for i in range(N_TRAIN + N_VALID + N_TEST + N_CHALLENGE):
        m = make_molecule(rs, int(rs.randint(2, 15)))
        n = m["num_nodes"]
        half = len(m["edges"]) // 2
        mol = {"z": [0 if i == DUMMY else 6] + [6] * (n - 1),
               "atom_feats": m["node_features"].tolist(),
               "bonds": [[int(a), int(b), f.tolist()] for (a, b), f in zip(
                   m["edges"][:half], m["edge_features"][:half])],
               "coords": m["dft_coords"].astype(np.float64).tolist(),
               "rdkit_base": m["rdkit_coords"].astype(np.float64).tolist(),
               "target": m["target"]}
        if i in WITH_HS:
            for h in range(2):
                mol["z"].append(1)
                mol["atom_feats"].append([0] * 9)
                mol["bonds"].append([0, n + h, [0, 0, 0]])
                mol["coords"].append([9.0, float(h), 0.0])
        mols.append(mol)
    return mols


def write_raw(raw_dir, n_sdf=N_TRAIN):
    mols = raw_molecules()
    (raw_dir / "fixture.json").write_text(json.dumps(
        {"molecules": mols, "n_sdf": n_sdf}))
    (raw_dir / "pcqm4m-v2-train.sdf").write_text("stand-in\n")


class Atom:
    def __init__(self, z, feats):
        self.z, self.feats = z, feats

    def GetAtomicNum(self):
        return self.z


class Bond:
    def __init__(self, i, j, feats):
        self.i, self.j, self.feats = i, j, feats

    def GetBeginAtomIdx(self):
        return self.i

    def GetEndAtomIdx(self):
        return self.j


class Conf:
    def __init__(self, coords):
        self.coords = np.asarray(coords, np.float64)

    def GetPositions(self):
        return self.coords


class Mol:
    def __init__(self, key, atoms, bonds, confs):
        self.key, self.atoms, self.bonds, self.confs = key, atoms, bonds, confs

    @classmethod
    def from_raw(cls, key, raw, with_conf):
        atoms = [Atom(z, f) for z, f in zip(raw["z"], raw["atom_feats"])]
        bonds = [Bond(i, j, f) for i, j, f in raw["bonds"]]
        return cls(key, atoms, bonds,
                   {0: Conf(raw["coords"])} if with_conf else {})

    def GetAtoms(self):
        return list(self.atoms)

    def GetBonds(self):
        return list(self.bonds)

    def GetNumAtoms(self):
        return len(self.atoms)

    def GetAtomWithIdx(self, i):
        return self.atoms[i]

    def GetConformer(self, id=0):
        return self.confs[id]

    def without(self, z):
        """A copy without the atoms of atomic number ``z`` (all at the
        end) and their bonds and coordinate rows."""
        keep = sum(a.z != z for a in self.atoms)
        return Mol(self.key, self.atoms[:keep],
                   [b for b in self.bonds if max(b.i, b.j) < keep],
                   {c: Conf(v.coords[:keep]) for c, v in self.confs.items()})


def fake_modules(raw_dir):
    """The seven fake modules over the fixture under ``raw_dir``."""
    fixture = json.loads((raw_dir / "fixture.json").read_text())
    mols = fixture["molecules"]
    splits = {"train": np.arange(N_TRAIN)}
    lo = N_TRAIN
    for name, k in (("valid", N_VALID), ("test-dev", N_TEST),
                    ("test-challenge", N_CHALLENGE)):
        splits[name] = np.arange(lo, lo + k)
        lo += k

    class PCQM4Mv2Dataset:
        def __init__(self, root, only_smiles=True):
            assert Path(root) == raw_dir and only_smiles

        def get_idx_split(self):
            return splits

        def __getitem__(self, i):
            hidden = i >= N_TRAIN + N_VALID
            return f"mol{i}", float("nan") if hidden else mols[i]["target"]

    def smiles2graph(smiles):
        raw = mols[int(smiles[3:])]
        pairs = [(i, j) for i, j, _ in raw["bonds"]]
        feats = [f for _, _, f in raw["bonds"]]
        return {"num_nodes": len(raw["z"]),
                "edge_index": np.asarray(
                    [[p for i, j in pairs for p in (i, j)],
                     [p for i, j in pairs for p in (j, i)]],
                    np.int64).reshape(2, -1),
                "node_feat": np.asarray(raw["atom_feats"], np.int64),
                "edge_feat": np.asarray([f for f in feats for _ in (0, 1)],
                                        np.int64).reshape(-1, 3)}

    class SDMolSupplier:
        def __init__(self, path, removeHs=True):
            assert Path(path) == raw_dir / "pcqm4m-v2-train.sdf"
            self.mols = [Mol.from_raw(i, mols[i], True)
                         for i in range(fixture["n_sdf"])]

        def __len__(self):
            return len(self.mols)

        def __getitem__(self, i):
            return self.mols[i]

        def __iter__(self):
            return iter(self.mols)

    chem = types.ModuleType("rdkit.Chem")
    chem.SDMolSupplier = SDMolSupplier
    chem.RemoveAllHs = lambda mol: mol.without(1)
    chem.RemoveHs = lambda mol: mol.without(1)
    chem.MolFromSmiles = lambda s: Mol.from_raw(int(s[3:]), mols[int(s[3:])],
                                                False)

    def add_hs(mol):
        n = mol.GetNumAtoms()
        return Mol(mol.key, mol.atoms + [Atom(1, [0] * 9)] * 2,
                   mol.bonds + [Bond(0, n, [0] * 3), Bond(0, n + 1, [0] * 3)],
                   dict(mol.confs))
    chem.AddHs = add_hs

    allchem = types.ModuleType("rdkit.Chem.AllChem")

    def embed(mol, numConfs, numThreads):
        if mol.key in EMBED_FAILS:
            raise RuntimeError("embedding failed")
        base = np.asarray(mols[mol.key]["rdkit_base"])
        base = np.concatenate([base, np.ones((2, 3))])
        for c in range(numConfs):
            mol.confs[c] = Conf(base + 0.125 * c)

    def optimize(mol, numThreads):
        if mol.key in NO_CONFORMERS:
            return []
        rs = np.random.RandomState(100 + mol.key)
        return [(int(rs.rand() < 0.3), float(rs.randn()))
                for _ in mol.confs]

    def compute_2d(mol):
        n = mol.GetNumAtoms()
        mol.confs[0] = Conf(np.stack([np.arange(n), -np.arange(n),
                                      np.zeros(n)], 1) * 1.5)

    allchem.EmbedMultipleConfs = embed
    allchem.MMFFOptimizeMoleculeConfs = optimize
    allchem.Compute2DCoords = compute_2d
    chem.AllChem = allchem

    rdkit = types.ModuleType("rdkit")
    rdkit.Chem = chem
    features = types.ModuleType("ogb.utils.features")
    features.atom_to_feature_vector = lambda atom: list(atom.feats)
    features.bond_to_feature_vector = lambda bond: list(bond.feats)
    utils = types.ModuleType("ogb.utils")
    utils.smiles2graph = smiles2graph
    utils.features = features
    lsc = types.ModuleType("ogb.lsc")
    lsc.PCQM4Mv2Dataset = PCQM4Mv2Dataset
    ogb = types.ModuleType("ogb")
    ogb.lsc, ogb.utils = lsc, utils
    return {"ogb": ogb, "ogb.lsc": lsc, "ogb.utils": utils,
            "ogb.utils.features": features, "rdkit": rdkit,
            "rdkit.Chem": chem, "rdkit.Chem.AllChem": allchem}


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """The raw fixture prepared by both packages: {package: out dir}."""
    raw = tmp_path_factory.mktemp("raw")
    write_raw(raw)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in fake_modules(raw).items():
            mp.setitem(sys.modules, name, mod)
        for pkg, module in PACKAGES.items():
            d = tmp_path_factory.mktemp(pkg)
            module.prepare_pcqm4mv2(str(raw), str(d))
            path = module.prepare_rdkit_coords(str(raw), str(d),
                                               progress=False)
            assert Path(path) == d / "rdkit_coords.parquet"
            out[pkg] = d
    return out


# -- the four files ----------------------------------------------------------

@pytest.mark.parametrize("name", ["records.parquet", "dft_coords.parquet",
                                  "rdkit_coords.parquet"])
def test_tables_equal_column_by_column(prepared, name):
    import pyarrow.parquet as pq
    got = pq.read_table(prepared["tgt_torch"] / name)
    want = pq.read_table(prepared["tgt_tpu"] / name)
    assert got.schema.equals(want.schema)
    assert got.column_names == want.column_names
    for col in want.column_names:
        assert got[col].equals(want[col]), f"{name}: {col}"
    assert got.num_rows == (N_TRAIN if name == "dft_coords.parquet"
                            else N_TRAIN + N_VALID + N_TEST)


def test_splits_equal(prepared):
    with np.load(prepared["tgt_torch"] / "splits.npz") as a, \
            np.load(prepared["tgt_tpu"] / "splits.npz") as b:
        assert sorted(a.files) == sorted(b.files) == sorted(
            ["train", "valid", "test-dev", "train-3d", "valid-3d"])
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        t3, v3 = a["train-3d"], a["valid-3d"]
        assert len(v3) == N_TRAIN // 4
        assert np.all(np.diff(t3) > 0) and np.all(np.diff(v3) > 0)
        np.testing.assert_array_equal(np.sort(np.concatenate([t3, v3])),
                                      a["train"])


def test_rows_read_back_equal_the_source(prepared):
    mols = raw_molecules()
    d = str(prepared["tgt_torch"])
    for split, cols in (("train", ["dft", "rdkit"]), ("valid", ["rdkit"]),
                        ("test-dev", ["rdkit"])):
        ds = PCQM4Mv2Dataset(split, d, return_idx=True,
                             additional_columns=[Coords(c) for c in cols],
                             transforms=[AddStructuralData()])
        for row_id in range(len(ds)):
            row = ds[row_id]
            raw = mols[row["idx"]]
            n = sum(z != 1 for z in raw["z"])      # hydrogens removed
            bonds = [b for b in raw["bonds"] if max(b[0], b[1]) < n]
            pairs = np.asarray([(i, j) for i, j, _ in bonds]
                               + [(j, i) for i, j, _ in bonds],
                               np.int64).reshape(-1, 2)
            feats = np.asarray([f for *_, f in bonds] * 2,
                               np.int64).reshape(-1, 3)
            want = AddStructuralData()({
                "num_nodes": n, "edges": pairs,
                "node_features": np.asarray(raw["atom_feats"][:n]),
                "edge_features": feats})
            for k in ("node_features", "distance_matrix", "feature_matrix"):
                np.testing.assert_array_equal(row[k], want[k],
                                              err_msg=f"{split} {k}")
            if split == "train":
                np.testing.assert_array_equal(
                    row["dft_coords"],
                    np.asarray(raw["coords"][:n], np.float32))
            if split == "test-dev":
                assert np.isnan(row["target"])
            else:
                assert row["target"] == np.float32(raw["target"])
            assert row["rdkit_coords"].shape == (n, 3)
            if row["idx"] == DUMMY:
                assert not row["rdkit_coords"].any()
            elif row["idx"] in EMBED_FAILS + NO_CONFORMERS:
                assert not row["rdkit_coords"][:, 2].any()     # 2D


# -- train3d_split without sklearn ---------------------------------------------

@pytest.mark.parametrize("n,holdout", [(3_378_606, 78_606), (12, 3),
                                       (192, 48), (5, 1), (2, 1)])
def test_train3d_split_equals_sklearn(n, holdout):
    from sklearn.model_selection import train_test_split
    idx = np.arange(n)
    tr, va = train_test_split(idx, test_size=holdout, random_state=777777)
    got = prepare.train3d_split(idx, holdout=holdout)
    for a, b in zip(got, (np.sort(tr), np.sort(va))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, jprepare.train3d_split(idx, holdout=holdout)):
        np.testing.assert_array_equal(a, b)
    assert (prepare.TRAIN3D_HOLDOUT, prepare.TRAIN3D_SEED) == (78606, 777777)


# -- misalignment ---------------------------------------------------------------

@pytest.mark.parametrize("pkg", PACKAGES)
def test_misaligned_sdf_raises(pkg, tmp_path, monkeypatch):
    write_raw(tmp_path, n_sdf=N_TRAIN - 1)
    for name, mod in fake_modules(tmp_path).items():
        monkeypatch.setitem(sys.modules, name, mod)
    module = PACKAGES[pkg]
    with pytest.raises(ValueError, match="does not match the OGB train"):
        module.prepare_pcqm4mv2(str(tmp_path), str(tmp_path / "out"))
    with pytest.raises(ValueError, match="does not match the OGB train"):
        module.prepare_rdkit_coords(str(tmp_path), str(tmp_path / "out"),
                                    progress=False)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_missing_toolkits_raise_import_error(pkg, monkeypatch):
    for name in ("ogb", "ogb.lsc", "rdkit", "rdkit.Chem"):
        monkeypatch.setitem(sys.modules, name, None)
    module = PACKAGES[pkg]
    with pytest.raises(ImportError, match="prepare_pcqm4mv2 needs ogb and"):
        module.prepare_pcqm4mv2("raw", "out")
    with pytest.raises(ImportError, match="prepare_rdkit_coords needs ogb"):
        module.prepare_rdkit_coords("raw", "out")


# -- the conformer choice, branch by branch ---------------------------------------

class FakeChem:
    """AddHs appends 2 hydrogens; RemoveHs strips them again (and keeps
    the conformers; the truncation is mol_to_rdkit_coords')."""

    @staticmethod
    def AddHs(mol):
        return Mol(mol.key, mol.atoms + [Atom(1, [])] * 2, [],
                   dict(mol.confs))

    @staticmethod
    def RemoveHs(mol):
        return Mol(mol.key, [a for a in mol.atoms if a.z != 1], [],
                   dict(mol.confs))


def fake_allchem(opt_results, conf_coords, fallback=None,
                 embed_raises=False):
    class A:
        @staticmethod
        def EmbedMultipleConfs(mol, numConfs, numThreads):
            if embed_raises:
                raise RuntimeError("embedding failed")
            for i, c in enumerate(conf_coords):
                mol.confs[i] = Conf(c)

        @staticmethod
        def MMFFOptimizeMoleculeConfs(mol, numThreads):
            return opt_results

        @staticmethod
        def Compute2DCoords(mol):
            mol.confs[0] = Conf(fallback)

    return A


def mol_of(zs, confs=None):
    return Mol(0, [Atom(z, []) for z in zs], [], dict(confs or {}))


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("results,index", [
    ([(0, 5.0), (0, 1.0), (0, 3.0)], 1),     # lowest energy
    ([(1, -100.0), (0, 9.0)], 1),            # converged beats unconverged
    ([(1, 2.0), (1, -1.0)], 1),              # none converged: lowest energy
    ([(0, 1.0), (0, 1.0)], 0),               # a tie: the first
])
def test_select_min_energy_conf(pkg, results, index):
    assert PACKAGES[pkg].select_min_energy_conf(results) == index


@pytest.mark.parametrize("pkg", PACKAGES)
def test_select_from_nothing_raises(pkg):
    with pytest.raises(ValueError, match="no conformers"):
        PACKAGES[pkg].select_min_energy_conf([])


def conformer_cases():
    n = 3
    confs = [np.full((n + 2, 3), float(i)) for i in range(3)]
    fb = np.asarray([[1.0, 2.0, 0.0], [3.0, 4.0, 0.0]])
    return {
        # conformer 1 is the converged minimum; hydrogens truncated
        "success": (mol_of([6] * n), fake_allchem(
            [(0, 7.0), (0, 2.0), (1, 0.5)], confs), np.full((n, 3), 1.0)),
        "embedding fails": (mol_of([6, 8]), fake_allchem(
            [], [], fallback=fb, embed_raises=True), fb),
        "no conformers": (mol_of([6, 8]), fake_allchem(
            [], [np.ones((4, 3))], fallback=fb + 9.0), fb + 9.0),
        "dummy atom": (mol_of([0, 6]), fake_allchem(
            [(0, 1.0)], [np.ones((4, 3))]), np.zeros((2, 3))),
        "dummy atom in the fallback": (mol_of([0, 6]), fake_allchem(
            [], [], fallback=fb, embed_raises=True), np.zeros((2, 3))),
    }


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", list(conformer_cases()))
def test_mol_to_rdkit_coords(pkg, case):
    mol, allchem, want = conformer_cases()[case]
    got = PACKAGES[pkg].mol_to_rdkit_coords(mol, num_confs=3, chem=FakeChem,
                                            allchem=allchem)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(np.float32))


# -- imports ----------------------------------------------------------------------

def test_tgt_torch_imports_ogb_and_rdkit_only_inside_functions():
    files = sorted((REPO / "tgt_torch").rglob("*.py"))
    inside = set()
    for path in files:
        tree = ast.parse(path.read_text())
        parents = {c: p for p in ast.walk(tree) for c in ast.iter_child_nodes(p)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top != "sklearn", f"{path}: imports {name}"
                if top not in ("ogb", "rdkit"):
                    continue
                p = parents.get(node)
                while p is not None and not isinstance(
                        p, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    p = parents.get(p)
                assert p is not None, f"{path}: imports {name} at module level"
                inside.add((path.name, p.name))
    assert {("prepare.py", "prepare_pcqm4mv2"), ("prepare.py", "_mol2graph"),
            ("prepare.py", "mol_to_rdkit_coords"),
            ("prepare.py", "prepare_rdkit_coords")} <= inside
