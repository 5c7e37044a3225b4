"""Dataset preparation in the PCQM4Mv2 on-disk format (counterpart of
tgt_tpu/data/prepare.py: the same inputs give the same files).

  records.parquet: idx, num_nodes, edges (flat i,j pairs), node_features
                   (flat, 9/atom), edge_features (flat, 3/bond), target
  {name}_coords.parquet: idx, {name}_coords (flat xyz)
  splits.npz: train / valid / test-dev / train-3d / valid-3d index arrays

- ``write_dataset`` writes them from any record iterator, and
  ``write_synthetic_dataset`` from the synthetic generator;
- ``prepare_pcqm4mv2``: OGB SDF + SMILES -> graph records, DFT coords and
  HOMO-LUMO targets (reference prepare_data.py:119-333), through the
  injectable core ``build_pcqm_records``; the train-3d/valid-3d holdout is
  sklearn's ``train_test_split(test_size=78606, random_state=777777)``,
  computed without sklearn (``train3d_split``);
- ``prepare_rdkit_coords``: 40 ETKDG conformers + MMFF, the minimum-energy
  one kept, 2D coordinates on failure (reference prepare_rdkit_coords.py:
  121-263), through the injectable core ``build_rdkit_coords``.

The real preparation needs ogb and rdkit, which are imported inside the
functions that use them.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional

import numpy as np

from tgt_torch.data.synthetic import make_molecule

TRAIN3D_HOLDOUT = 78606
TRAIN3D_SEED = 777777


def train3d_split(train_indices: np.ndarray,
                  holdout: int = TRAIN3D_HOLDOUT,
                  seed: int = TRAIN3D_SEED):
    """The train-3d/valid-3d holdout of the reference, both sorted
    (prepare_data.py:270-274). sklearn's ``train_test_split(x,
    test_size=holdout, random_state=seed)`` draws one permutation
    ``p = RandomState(seed).permutation(len(x))`` and returns train
    ``x[p[holdout:]]`` and test ``x[p[:holdout]]``; this draws the same
    one."""
    x = np.asarray(train_indices)
    if not 0 < holdout < len(x):
        raise ValueError(f"a holdout of {holdout} from {len(x)} indices")
    p = np.random.RandomState(seed).permutation(len(x))
    return np.sort(x[p[holdout:]]), np.sort(x[p[:holdout]])


def write_dataset(records: Iterable[Dict], out_dir: str,
                  coords_names: Iterable[str] = ("dft",),
                  splits: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Write records + coords parquets + splits.npz in the dataset format."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(out_dir, exist_ok=True)
    cols: Dict[str, List] = {"idx": [], "num_nodes": [], "edges": [],
                             "node_features": [], "edge_features": [],
                             "target": []}
    coord_cols = {name: {"idx": [], f"{name}_coords": []}
                  for name in coords_names}
    for i, rec in enumerate(records):
        idx = rec.get("idx", i)
        cols["idx"].append(idx)
        cols["num_nodes"].append(int(rec["num_nodes"]))
        cols["edges"].append(np.asarray(rec["edges"], np.int64)
                             .reshape(-1).tolist())
        cols["node_features"].append(np.asarray(rec["node_features"], np.int64)
                                     .reshape(-1).tolist())
        cols["edge_features"].append(np.asarray(rec["edge_features"], np.int64)
                                     .reshape(-1).tolist())
        t = rec.get("target")
        cols["target"].append(None if t is None or
                              (isinstance(t, float) and np.isnan(t)) else
                              float(t))
        for name in coords_names:
            key = f"{name}_coords"
            if key in rec:
                coord_cols[name]["idx"].append(idx)
                coord_cols[name][key].append(
                    np.asarray(rec[key], np.float32).reshape(-1).tolist())

    pq.write_table(pa.table(cols), os.path.join(out_dir, "records.parquet"))
    for name in coords_names:
        if coord_cols[name]["idx"]:
            pq.write_table(pa.table(coord_cols[name]),
                           os.path.join(out_dir, f"{name}_coords.parquet"))
    if splits is not None:
        np.savez(os.path.join(out_dir, "splits.npz"),
                 **{k: np.asarray(v) for k, v in splits.items()})


def write_synthetic_dataset(out_dir: str, num_samples: int = 64,
                            max_nodes: int = 16, seed: int = 0) -> None:
    """A synthetic dataset in the exact on-disk format: the first 75% of
    the molecules are ``train`` (its last eighth ``valid-3d``, the rest
    ``train-3d``), the others ``valid`` and ``test-dev``."""
    rs = np.random.RandomState(seed)
    records = []
    for i in range(num_samples):
        n = int(rs.randint(4, max_nodes + 1))
        records.append({**make_molecule(rs, n), "idx": i})
    idx = np.arange(num_samples)
    n_train = int(num_samples * 0.75)
    train = idx[:n_train]
    valid = idx[n_train:]
    hold = max(1, n_train // 8)
    splits = {
        "train": train, "valid": valid, "test-dev": valid,
        "train-3d": train[:-hold], "valid-3d": train[-hold:],
    }
    write_dataset(records, out_dir, coords_names=("dft", "rdkit"),
                  splits=splits)


# ---------------------------------------------------------------------------
# the real PCQM4Mv2 (ogb and rdkit are imported where they are used)
# ---------------------------------------------------------------------------

def prepare_pcqm4mv2(raw_dir: str, out_dir: str) -> None:
    """OGB PCQM4Mv2 -> dataset format (reference prepare_data.py:119-333)."""
    try:
        from ogb.lsc import PCQM4Mv2Dataset as OGBDataset
        from ogb.utils import smiles2graph
        from rdkit import Chem
    except ImportError as e:
        raise ImportError(
            "prepare_pcqm4mv2 needs ogb and rdkit (not installed in this "
            "environment); download data/PCQM from the reference release or "
            "run on a machine with ogb+rdkit") from e

    ogb_ds = OGBDataset(root=raw_dir, only_smiles=True)
    sdf_path = os.path.join(raw_dir, "pcqm4m-v2-train.sdf")
    supplier = Chem.SDMolSupplier(sdf_path, removeHs=True)
    records, splits = build_pcqm_records(ogb_ds, supplier, smiles2graph,
                                         remove_all_hs=Chem.RemoveAllHs)
    write_dataset(records, out_dir, coords_names=("dft",), splits=splits)


def build_pcqm_records(ogb_ds, supplier, smiles2graph, mol2graph=None,
                       remove_all_hs=None):
    """The preparation's core, with its dependencies injected; returns
    (records, splits) for ``write_dataset``.

    As the reference (prepare_data.py:174-279):
    - train molecules come from the SDF supplier in order and must align
      one for one with the OGB train split (its assert at :237 raises
      here); each SDF molecule goes through ``remove_all_hs``
      (``Chem.RemoveAllHs``, :199);
    - only the valid and test-dev splits are built from SMILES (:246-263),
      never test-challenge;
    - train-3d/valid-3d = ``train3d_split`` with the holdout of 78,606,
      scaled to a quarter of the train split when that has no more
      molecules than the holdout (fixture-sized inputs).
    """
    split = ogb_ds.get_idx_split()
    n_sdf = len(supplier)
    train_idx = np.asarray(split["train"])
    if not np.array_equal(train_idx, np.arange(n_sdf)):
        raise ValueError(
            f"SDF molecule count/order ({n_sdf}) does not match the OGB "
            f"train split ({len(train_idx)} idx) — reference "
            f"prepare_data.py:237 asserts exact alignment")

    mol2graph = mol2graph or _mol2graph
    records = []
    for i in range(n_sdf):  # train molecules come from the SDF (3D)
        mol = supplier[i]
        if remove_all_hs is not None:
            mol = remove_all_hs(mol)
        g = mol2graph(mol)
        g["dft_coords"] = np.asarray(
            mol.GetConformer().GetPositions(), np.float32)
        _, target = ogb_ds[i]
        g["idx"] = i
        g["target"] = target
        records.append(g)
    for key in ("valid", "test-dev"):  # SMILES path; test-challenge excluded
        for idx in np.asarray(split[key]):
            smiles, target = ogb_ds[int(idx)]
            g = _ogb_graph(smiles2graph(smiles))
            g["idx"] = int(idx)
            g["target"] = target
            records.append(g)

    holdout = TRAIN3D_HOLDOUT if len(train_idx) > TRAIN3D_HOLDOUT \
        else max(1, len(train_idx) // 4)
    train3d, valid3d = train3d_split(train_idx, holdout=holdout)
    splits = {"train": train_idx,
              "valid": np.asarray(split["valid"]),
              "test-dev": np.asarray(split["test-dev"]),
              "train-3d": train3d, "valid-3d": valid3d}
    return records, splits


def _ogb_graph(g) -> Dict:
    """An OGB ``smiles2graph`` dict -> a record's graph."""
    return {"num_nodes": int(g["num_nodes"]),
            "edges": np.asarray(g["edge_index"]).T,
            "node_features": np.asarray(g["node_feat"]),
            "edge_features": np.asarray(g["edge_feat"])}


def _mol2graph(mol) -> Dict:
    """An RDKit molecule -> a record's graph, with OGB's atom and bond
    features; each bond in both directions."""
    from ogb.utils.features import atom_to_feature_vector, bond_to_feature_vector
    node_feats = np.asarray([atom_to_feature_vector(a)
                             for a in mol.GetAtoms()], np.int64)
    edges, edge_feats = [], []
    for b in mol.GetBonds():
        i, j = b.GetBeginAtomIdx(), b.GetEndAtomIdx()
        f = bond_to_feature_vector(b)
        edges += [(i, j), (j, i)]
        edge_feats += [f, f]
    return {"num_nodes": mol.GetNumAtoms(),
            "edges": np.asarray(edges, np.int64).reshape(-1, 2),
            "node_features": node_feats,
            "edge_features": np.asarray(edge_feats, np.int64).reshape(-1, 3)}


def select_min_energy_conf(opt_results) -> int:
    """Index of the conformer to keep from MMFFOptimizeMoleculeConfs'
    (not_converged, energy) pairs: the reference's ``min(enumerate(res),
    key=lambda x: x[1])`` (prepare_rdkit_coords.py:139), so by tuple order
    a converged conformer beats any unconverged one, then the lowest
    energy wins."""
    if not opt_results:
        raise ValueError("no conformers to select from")
    index, _ = min(enumerate(opt_results), key=lambda x: x[1])
    return index


def mol_to_rdkit_coords(mol, num_confs: int = 40, *, chem=None,
                        allchem=None) -> np.ndarray:
    """3D coordinates of one molecule by ETKDG + MMFF.

    As the reference (prepare_rdkit_coords.py:121-150):
    - AddHs -> EmbedMultipleConfs(numConfs=40) -> MMFFOptimizeMoleculeConfs
      -> RemoveHs -> the conformer ``select_min_energy_conf`` picks;
    - any exception falls back to Compute2DCoords on the original molecule;
    - a leading dummy atom (atomic number 0) gives all-zero coordinates;
    - coordinates are truncated to the heavy atoms, float32.

    ``chem`` and ``allchem`` stand for rdkit's ``Chem`` and ``AllChem``,
    which are imported when either is not given."""
    if chem is None or allchem is None:
        from rdkit import Chem as chem
        from rdkit.Chem import AllChem as allchem
    try:
        new_mol = chem.AddHs(mol)
        allchem.EmbedMultipleConfs(new_mol, numConfs=num_confs, numThreads=0)
        res = allchem.MMFFOptimizeMoleculeConfs(new_mol, numThreads=0)
        new_mol = chem.RemoveHs(new_mol)
        conf = new_mol.GetConformer(id=select_min_energy_conf(res))
    except Exception:
        new_mol = mol
        allchem.Compute2DCoords(new_mol)
        conf = new_mol.GetConformer()

    n = new_mol.GetNumAtoms()
    if new_mol.GetAtomWithIdx(0).GetAtomicNum() == 0:
        return np.zeros((n, 3), np.float32)
    return np.asarray(conf.GetPositions())[:n].astype(np.float32)


def prepare_rdkit_coords(raw_dir: str, out_dir: Optional[str] = None,
                         num_confs: int = 40,
                         progress: bool = True) -> str:
    """ETKDG conformers of every PCQM4Mv2 molecule ->
    ``rdkit_coords.parquet`` (reference prepare_rdkit_coords.py:153-263).
    Needs rdkit and ogb. Returns the parquet's path."""
    try:
        from ogb.lsc import PCQM4Mv2Dataset as OGBDataset
        from rdkit import Chem
        from rdkit.Chem import AllChem
    except ImportError as e:
        raise ImportError(
            "prepare_rdkit_coords needs ogb and rdkit (not installed in "
            "this environment)") from e
    sdf_path = os.path.join(raw_dir, "pcqm4m-v2-train.sdf")
    return build_rdkit_coords(
        Chem.SDMolSupplier(sdf_path),
        lambda: OGBDataset(root=raw_dir, only_smiles=True),
        out_dir or raw_dir, Chem, AllChem, num_confs, progress)


def build_rdkit_coords(supplier, load_ogb, out_dir: str, chem, allchem,
                       num_confs: int = 40, progress: bool = False) -> str:
    """The conformer preparation's core, with its dependencies injected:
    ``supplier`` iterates the SDF's molecules, ``load_ogb()`` gives the OGB
    dataset once they are done, ``chem`` and ``allchem`` stand for rdkit's
    modules. Writes ``rdkit_coords.parquet`` under ``out_dir`` and returns
    its path.

    Train molecules come from the SDF (all hydrogens removed first, then
    re-embedded; reference prepare_rdkit_coords.py:153-183), and must
    align with the OGB train split (:205); valid and test-dev molecules
    from their SMILES (:186-223)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(out_dir, exist_ok=True)

    def track(it, desc):
        if not progress:
            return it
        try:
            from tqdm import tqdm
            return tqdm(it, desc=desc)
        except ImportError:
            return it

    idx_col: List[int] = []
    coords_col: List[List[float]] = []
    for i, mol in enumerate(track(supplier, "sdf")):
        mol = chem.RemoveAllHs(mol)
        idx_col.append(i)
        coords_col.append(mol_to_rdkit_coords(
            mol, num_confs, chem=chem, allchem=allchem).ravel().tolist())

    dataset = load_ogb()
    split = dataset.get_idx_split()
    if not np.array_equal(np.asarray(split["train"]), np.asarray(idx_col)):
        raise ValueError("SDF molecule order does not match the OGB train "
                         "split (reference prepare_rdkit_coords.py:205)")
    for name in ("valid", "test-dev"):
        for idx in track(split[name], name):
            smiles, _ = dataset[int(idx)]
            mol = chem.MolFromSmiles(smiles)
            idx_col.append(int(idx))
            coords_col.append(mol_to_rdkit_coords(
                mol, num_confs, chem=chem, allchem=allchem).ravel().tolist())

    path = os.path.join(out_dir, "rdkit_coords.parquet")
    pq.write_table(pa.table({"idx": idx_col, "rdkit_coords": coords_col}),
                   path)
    return path
