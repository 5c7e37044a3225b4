"""Batch inference / serving API (counterpart of tgt_tpu/serving.py): the
published two-stage inference, on the CUDA card unless the caller passes
``device="cpu"``, with size-sorted bucketed batching and MC-dropout
averaging.

- ``DistancePredictor``: interatomic distance-bin probabilities, and the
  per-draw argmax bins samples, from coordinates (stage 1);
- ``GapPredictor``: the HOMO-LUMO gap from bins samples (draw i decodes
  stored sample i % S on the device), distances or coordinates (stage 2);
- ``TwoStagePredictor``: both stages as one served object.

    two = TwoStagePredictor.from_model_dirs("models/.../dist_pred_dir",
                                            "models/.../gap_pred_dir",
                                            mc_samples=10)
    gaps = two.predict(list_of_molecule_dicts)        # (M,) eV
    pred = DistancePredictor.from_model_dir("models/.../dist_pred_dir")
    probs = pred.predict(list_of_molecule_dicts)    # (M, Nmax, Nmax, bins)
    bins = pred.predict_bins(list_of_molecule_dicts)  # (M, S, Nmax, Nmax)

Molecule dict schema (dataset rows before the structural transform):
num_nodes, edges (m, 2), node_features (n, 9), edge_features (m, 3), plus
dist_input (n, n) | coords (n, 3) | rdkit_coords (n, 3) | dist_bins
(S, n, n).

MC-draw schedule (tgt_tpu's ``mc_mode``), decided per bucket by
``_mc_schedule``: ``map`` runs the S draws of a device batch as S forwards
of b rows; ``vmap`` as one forward of S*b rows, draw-major (row ``s*b + r``
is draw s of molecule r), whose every dropout mask and kernel row seed
equals ``map``'s draw for draw (``models/encoder.py``); ``auto`` takes vmap
for buckets of at most ``mc_vmap_max_nodes`` nodes, map above. The
defaults, ``map`` and 0, are tgt_tpu's: ``auto`` is map everywhere until a
caller raises the bound for a bucket measured on the card (PERF.md). vmap
trades S-fold activations for one forward's host launches.

``warmup()`` serves one dummy molecule per bucket through the configured
schedule, so that the first request finds the kernels loaded and the
allocator's blocks in place. tgt_tpu's TPU-only machinery is not ported:
the persistent compile cache, the dense kernels' data mesh, and warmup's
relay probe and watchdog thread (PyTorch runs eagerly: nothing compiles).

Spans (``tgt_torch.utils.tracing``, recorded while torch's profiler
runs): ``serve.predict`` around each public call (``molecules``;
``request``, the id that every span of the request shares: a call inside
another keeps the outer one's), and inside it ``serve.prepare`` (the
structural transform), per device batch ``serve.collate`` (collation,
padding, the draw seeds and the host-to-device copies; ``bucket``,
``rows_real``, ``rows``) and ``serve.forward`` (``schedule``, ``draws``,
``rows_real``: real molecules x draws, ``rows_run``: device rows x draws),
then ``serve.copy_back`` (the wait for the card in ``.cpu()``) and
``serve.scatter``.
"""
from __future__ import annotations

import itertools
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from tgt_torch.core.config import load_yaml
from tgt_torch.core.device import resolve_device
from tgt_torch.data.collate import add_edge_mask, pad_batch_dim, padded_collate
from tgt_torch.data.structural import AddStructuralData
from tgt_torch.models.convert import load_jax_npz, state_dict_from_jax_params
from tgt_torch.models.heads import make_model
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.schemes import get_scheme
from tgt_torch.schemes.commons import bins2dist, coords2dist, stack_draws
from tgt_torch.utils import tracing

_FEED_KEYS = ("node_features", "distance_matrix", "feature_matrix",
              "node_mask", "edge_mask")

_request_ids = itertools.count()


def _request(span: Optional[Dict], molecules: List[Dict]) -> None:
    """A public call's ``serve.predict`` row (None while no profiler
    records): its molecules and a new request id, unless a call open
    around it gave it one."""
    if span is not None:
        span["molecules"] = len(molecules)
        if "request" not in span:
            span["request"] = next(_request_ids)


class _BasePredictor:
    MODEL = "gap"
    # Output axes that are per-node (and thus bucket-size-dependent),
    # declared per subclass.
    NODE_AXES: tuple = ()

    def __init__(self, model: nn.Module, model_cfg: TGTConfig,
                 mc_samples: int = 10, batch_size: int = 16,
                 buckets: Sequence[int] = (16, 32, 48, 64), seed: int = 0,
                 device=None, mc_mode: str = "map",
                 mc_vmap_max_nodes: int = 0):
        if mc_mode not in ("auto", "map", "vmap"):
            raise ValueError(f"mc_mode must be auto|map|vmap, got {mc_mode}")
        self.mc_mode = mc_mode
        self.mc_vmap_max_nodes = mc_vmap_max_nodes
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = model_cfg
        self.mc_samples = mc_samples
        self.batch_size = batch_size
        self.buckets = tuple(buckets)
        self._transform = AddStructuralData()
        # host generator of the per-draw seeds: one draw per device batch
        self._seeds = torch.Generator().manual_seed(seed)

    @classmethod
    def from_model_dir(cls, model_dir: str, mc_samples: int = 10,
                       batch_size: int = 16,
                       buckets: Sequence[int] = (16, 32, 48, 64),
                       which: str = "checkpoint", use_pallas=None,
                       device=None, **predictor_kwargs) -> "_BasePredictor":
        """Load config.yaml and the tgt_tpu checkpoint
        (``<which>/model.npz``, written by ``save_pytree``) from a model
        dir. ``use_pallas`` overrides the trained config's kernel choice;
        other keywords (``seed``, ``mc_mode``, ``mc_vmap_max_nodes``, ...)
        go to the constructor."""
        cfg_dict = load_yaml(os.path.join(model_dir, "config.yaml"))
        scheme = get_scheme(cfg_dict["scheme"])(cfg_dict, command="evaluate")
        model_cfg = scheme.model_cfg
        if use_pallas is not None:
            model_cfg = model_cfg.replace(use_pallas=use_pallas)
        device = resolve_device(device)
        model = make_model(cls.MODEL, model_cfg, device=device)
        params = load_jax_npz(os.path.join(model_dir, which, "model.npz"))
        model.load_state_dict(state_dict_from_jax_params(params, model_cfg))
        pred = cls(model, model_cfg, mc_samples=mc_samples,
                   batch_size=batch_size, buckets=buckets, device=device,
                   **predictor_kwargs)
        pred.scheme_cfg = scheme.cfg
        return pred

    # -- MC-draw schedule --------------------------------------------------
    def _mc_schedule(self, feed: Dict[str, torch.Tensor]) -> str:
        """The schedule of this feed's bucket, "vmap" or "map"
        (tgt_tpu/serving.py:88-95)."""
        if self.mc_mode == "map":
            return "map"
        n = feed["node_features"].shape[1]
        if self.mc_mode == "vmap" or n <= self.mc_vmap_max_nodes:
            return "vmap"
        return "map"

    # -- batched dispatch --------------------------------------------------
    def _run(self, rows: List[Dict],
             forward: Callable[[Dict[str, torch.Tensor], List[int]],
                               torch.Tensor],
             node_axes: tuple) -> np.ndarray:
        """Size-sorted bucketed batching around ``forward(feed, seeds)``.
        Every device batch is queued before any result is copied back, so
        host collation of batch t+1 overlaps the card computing batch t.
        Outputs come back in input order."""
        if not rows:
            return np.zeros((0,), np.float32)
        sizes = np.asarray([r["num_nodes"] for r in rows])
        order = np.argsort(sizes, kind="stable")

        pending = []
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            chunk = [rows[i] for i in idx]
            with tracing.span("serve.collate") as span:
                batch = add_edge_mask(padded_collate(chunk,
                                                     buckets=self.buckets))
                batch, _ = pad_batch_dim(batch, self.batch_size)
                seeds = torch.randint(0, 2**62, (self.mc_samples,),
                                      generator=self._seeds).tolist()
                with torch.inference_mode():
                    feed = self._feed_of(batch)
                if span is not None:
                    span.update(bucket=int(batch["node_mask"].shape[1]),
                                rows_real=len(chunk), rows=self.batch_size)
            with tracing.span("serve.forward") as span, \
                    torch.inference_mode():
                if span is not None:
                    draws = len(seeds)
                    span.update(schedule=self._mc_schedule(feed), draws=draws,
                                rows_real=len(chunk) * draws,
                                rows_run=int(feed["node_mask"].shape[0])
                                * draws)
                out = forward(feed, seeds)
            pending.append((idx, out[:len(chunk)]))

        with tracing.span("serve.copy_back"):
            outs = [(idx, out.cpu().numpy()) for idx, out in pending]
        with tracing.span("serve.scatter"):
            # per-molecule node axes differ across buckets: zero-pad the
            # declared node axes to the largest before scattering back
            n_max = max((o.shape[a] for _, o in outs for a in node_axes
                         if o.ndim > a), default=0)
            result = None
            for idx, out in outs:
                out = self._pad_nodes(out, n_max, node_axes)
                if result is None:
                    result = np.zeros((len(rows),) + out.shape[1:],
                                      out.dtype)
                result[idx] = out
            return result

    def _prepare_rows(self, molecules: List[Dict]) -> List[Dict]:
        with tracing.span("serve.prepare"):
            rows = []
            for mol in molecules:
                row = dict(mol)
                if "distance_matrix" not in row:
                    row = self._transform(row)
                row.setdefault("node_mask",
                               np.ones(row["num_nodes"], np.uint8))
                rows.append(row)
            return rows

    def _warmup_one(self, nb: int) -> None:
        """One dummy predict at bucket ``nb`` (tgt_tpu/serving.py:227-237)."""
        mol = {
            "num_nodes": nb,
            "edges": np.zeros((0, 2), np.int64),
            "node_features": np.ones((nb, 9), np.int64),
            "edge_features": np.zeros((0, 3), np.int64),
        }
        if self.cfg.embed_3d_type != "none":
            mol["dist_input"] = np.zeros((nb, nb), np.float32)
        self.predict([mol])

    def warmup(self, per_bucket_timeout: Optional[float] = 900.0,
               retries: int = 2) -> None:
        """Serve one dummy molecule per bucket through the configured MC
        schedule, so that the first real request pays no first-call cost:
        the kernels' modules loaded, cuBLAS's handles and the caching
        allocator's blocks (vmap's S*b-row activations) in place (tgt_tpu:
        serving.py:195-293, which compiles each bucket's program). A bucket
        that fails ``retries + 1`` times raises RuntimeError from the last
        failure. ``per_bucket_timeout`` is accepted and has no effect: it
        bounds tgt_tpu's compile through a TPU tunnel, and the port compiles
        nothing."""
        for nb in self.buckets:
            last_exc: Optional[BaseException] = None
            for _ in range(retries + 1):
                try:
                    self._warmup_one(nb)
                    break
                except Exception as exc:    # retried, then raised below
                    last_exc = exc
            else:
                raise RuntimeError(
                    f"serving warmup failed for bucket {nb} after "
                    f"{retries + 1} attempts") from last_exc

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _feed_of(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    @staticmethod
    def _pad_nodes(out: np.ndarray, n_max: int,
                   node_axes: tuple) -> np.ndarray:
        """Zero-pad the declared per-node axes to n_max."""
        pad = [(0, 0)] * out.ndim
        grew = False
        for a in node_axes:
            if out.ndim > a and out.shape[a] < n_max:
                pad[a] = (0, n_max - out.shape[a])
                grew = True
        return np.pad(out, pad) if grew else out


class DistancePredictor(_BasePredictor):
    """Interatomic distance-bin probabilities from coordinates."""

    MODEL = "distance"
    NODE_AXES = (1, 2)  # output is (b, N, N, bins)

    def _feed_of(self, batch):
        feed = {k: self._tensor(batch[k]) for k in _FEED_KEYS}
        if "dist_input" in batch:
            feed["dist_input"] = self._tensor(batch["dist_input"]).float()
        elif "coords" in batch:
            feed["dist_input"] = coords2dist(self._tensor(batch["coords"]).float())
        elif "rdkit_coords" in batch:
            feed["dist_input"] = coords2dist(
                self._tensor(batch["rdkit_coords"]).float())
        elif self.cfg.embed_3d_type != "none":
            raise ValueError("model expects coords or dist_input")
        return feed

    def _symmetric_probs(self, feed, seed) -> torch.Tensor:
        logits = self.model(feed, deterministic=False, seed=seed)
        p = torch.softmax(logits.float(), dim=-1)
        return p + p.transpose(1, 2)

    def _stacked_probs(self, feed, seeds: List[int]) -> torch.Tensor:
        """(S, b, N, N, bins) symmetrised probabilities of the S draws, from
        one draw-stacked forward of S*b rows."""
        p = self._symmetric_probs(stack_draws(feed, len(seeds)), seeds)
        return p.view(len(seeds), -1, *p.shape[1:])

    def _mc_forward(self, feed, seeds: List[int]) -> torch.Tensor:
        """Mean over the draws of (softmax + its pair transpose) / 2."""
        if self._mc_schedule(feed) == "vmap":
            total = self._stacked_probs(feed, seeds).sum(dim=0)
        else:
            total = sum(self._symmetric_probs(feed, s) for s in seeds)
        return total / len(seeds) / 2.0

    def _bins_forward(self, feed, seeds: List[int]) -> torch.Tensor:
        """Per-draw symmetrised argmax bins (b, S, N, N) int32 (reference
        dist_pred/scheme.py:181-205)."""
        if self._mc_schedule(feed) == "vmap":
            bins = self._stacked_probs(feed, seeds).argmax(dim=-1)
            return bins.to(torch.int32).transpose(0, 1)
        return torch.stack([self._symmetric_probs(feed, s).argmax(dim=-1)
                            .to(torch.int32) for s in seeds], dim=1)

    def predict(self, molecules: List[Dict]) -> np.ndarray:
        """MC-averaged symmetric bin probabilities (M, Nmax, Nmax, bins)
        float32, input order preserved."""
        with tracing.span("serve.predict") as span:
            _request(span, molecules)
            return self._run(self._prepare_rows(molecules),
                             self._mc_forward, self.NODE_AXES)

    def predict_bins(self, molecules: List[Dict]) -> np.ndarray:
        """Per-draw argmax bins samples (M, mc_samples, Nmax, Nmax) int32,
        input order preserved."""
        with tracing.span("serve.predict") as span:
            _request(span, molecules)
            return self._run(self._prepare_rows(molecules),
                             self._bins_forward, (2, 3))


class GapPredictor(_BasePredictor):
    """HOMO-LUMO gap from predicted-distance bins, distances or coordinates.

    Bins follow the published MC protocol (reference
    finetune/scheme.py:103-137): MC-dropout draw i reads stored bins sample
    i % S and decodes it to distances on the device (``bins2dist``: +0.5,
    symmetrised, zero diagonal); the gap is the mean of all draws."""

    MODEL = "gap"
    NODE_AXES = ()      # one gap per molecule

    def __init__(self, *a, bins_meta: Optional[Dict] = None, **kw):
        super().__init__(*a, **kw)
        self.bins_meta = bins_meta    # {num_bins, range_bins} for bins input

    def _feed_of(self, batch):
        feed = {k: self._tensor(batch[k]) for k in _FEED_KEYS}
        if "dist_input" in batch:
            feed["dist_input"] = self._tensor(batch["dist_input"]).float()
        elif "dist_bins" in batch and self.bins_meta:
            bins = batch["dist_bins"]
            if bins.ndim == 3:        # (b, n, n): one stored sample
                bins = bins[:, None]
            feed["dist_bins"] = self._tensor(bins)    # (b, S, n, n)
        elif "coords" in batch:
            feed["dist_input"] = coords2dist(self._tensor(batch["coords"]).float())
        elif self.cfg.embed_3d_type != "none":
            raise ValueError("model expects 3D input: provide dist_input, "
                             "dist_bins (with bins_meta) or coords")
        return feed

    def _mc_forward(self, feed, seeds: List[int]) -> torch.Tensor:
        """Mean gap over the draws, draw i on bins sample i % S."""
        bins = feed.pop("dist_bins", None)
        if self._mc_schedule(feed) == "vmap":
            return self._stacked_gaps(feed, bins, seeds).mean(dim=0)
        total = 0.0
        for i, seed in enumerate(seeds):
            f = feed
            if bins is not None:
                f = dict(feed, dist_input=bins2dist(
                    bins[:, i % bins.shape[1]], self.bins_meta["num_bins"],
                    self.bins_meta["range_bins"]))
            total = total + self.model(f, deterministic=False,
                                       seed=seed).float()
        return total / len(seeds)

    def _stacked_gaps(self, feed, bins, seeds: List[int]) -> torch.Tensor:
        """(S, b) gaps of the S draws from one draw-stacked forward; row
        block i decodes bins sample i % S (tgt_tpu/serving.py:353-372)."""
        draws = len(seeds)
        stacked = stack_draws(feed, draws)
        if bins is not None:
            b, s_avail, n, _ = bins.shape
            idx = torch.arange(draws, device=bins.device) % s_avail
            stacked["dist_input"] = bins2dist(
                bins[:, idx].transpose(0, 1).reshape(draws * b, n, n),
                self.bins_meta["num_bins"], self.bins_meta["range_bins"])
        gaps = self.model(stacked, deterministic=False, seed=seeds)
        return gaps.float().view(draws, -1)

    def predict(self, molecules: List[Dict]) -> np.ndarray:
        """MC-averaged gaps (M,) float32, input order preserved."""
        with tracing.span("serve.predict") as span:
            _request(span, molecules)
            return self._run(self._prepare_rows(molecules),
                             self._mc_forward, self.NODE_AXES)


class TwoStagePredictor:
    """The published inference protocol as one served object: molecule
    (+ RDKit coordinates) -> the distance predictor's S per-draw
    symmetrised argmax bins samples (reference dist_pred/scheme.py:181-205)
    -> the gap predictor, draw i on sample i % S decoded on the device
    (finetune/scheme.py:103-137).

        two = TwoStagePredictor.from_model_dirs(dist_dir, gap_dir)
        gaps = two.predict(list_of_molecule_dicts)   # eV
    """

    def __init__(self, distance: DistancePredictor, gap: GapPredictor,
                 num_bins: Optional[int] = None, range_bins: float = 8.0):
        self.distance = distance
        self.gap = gap
        self.num_bins = num_bins or distance.cfg.num_dist_bins
        self.range_bins = range_bins
        if gap.bins_meta is None:
            gap.bins_meta = {"num_bins": self.num_bins,
                             "range_bins": self.range_bins}

    @classmethod
    def from_model_dirs(cls, dist_dir: str, gap_dir: str,
                        range_bins: Optional[float] = None,
                        **kw) -> "TwoStagePredictor":
        """Both stages from their model dirs; ``kw`` (``mc_samples``,
        ``mc_mode``, ``mc_vmap_max_nodes``, ``device``, ...) goes to both
        ``from_model_dir`` calls. ``range_bins`` defaults to the distance
        model's trained ``range_dist_bins``: a model trained with another
        bin range would otherwise decode scaled distances."""
        distance = DistancePredictor.from_model_dir(dist_dir, **kw)
        if range_bins is None:
            range_bins = float(distance.scheme_cfg.range_dist_bins)
        return cls(distance, GapPredictor.from_model_dir(gap_dir, **kw),
                   range_bins=range_bins)

    def predict(self, molecules: List[Dict]) -> np.ndarray:
        """Gaps (M,) float32, input order preserved."""
        with tracing.span("serve.predict") as span:
            _request(span, molecules)
            # the structural transform runs once; both stages take its rows
            rows = self.distance._prepare_rows(molecules)
            if not rows:
                return np.zeros((0,), np.float32)
            bins = self.distance.predict_bins(rows)   # (M, S, Nmax, Nmax)
            gap_rows = []
            for row, b in zip(rows, bins):
                n = int(row["num_nodes"])
                g = {k: v for k, v in row.items()
                     if k not in ("coords", "rdkit_coords", "dist_input")}
                # bins2dist reads the strict upper triangle (the packed
                # on-disk convention) and symmetrises
                g["dist_bins"] = np.triu(b[:, :n, :n],
                                         k=1).astype(np.float32)
                gap_rows.append(g)
            return self.gap.predict(gap_rows)
