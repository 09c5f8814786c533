"""SegDINO3D architecture: backbone -> queries -> decoder.

Counterpart of ``segdino3d_tpu/models/architecture/segdino3d.py``: the scene
range (and GT instance centers/sizes) from elastic-or-raw coordinates, the
eval forward in which every superpoint is a query, and the training forward
(``module.train()``), which subsamples the queries at random with
``query_thr`` and gathers the GT targets to the selection.  With
``query_num > 0`` both forwards take the top-k superpoints by the decoder's
``score_superpoints`` instead; with ``add_positional_embedding=False`` the
decoder gets no query positions.  Both forwards carry the
backbone's plan overflow flag as ``outputs["plan_overflow"]`` (a 0-d bool
tensor, set when a plan built on the device outgrew its capacities), which
the eval driver and the training step read.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from segdino3d_tpu_torch.gtypes import BackboneOutput, SceneBatch


def _scene_coords(batch: SceneBatch, voxel_size: float) -> torch.Tensor:
    if batch.elastic_coords is not None:
        return batch.elastic_coords * voxel_size
    return batch.points[..., :3]


def scene_range(batch: SceneBatch, voxel_size: float) -> torch.Tensor:
    """(B, 2, 3) per-scene [min, max] over valid points."""
    coords = _scene_coords(batch, voxel_size)
    pv = batch.point_valid[..., None]
    mins = torch.where(pv, coords, 1e9).amin(dim=1)
    maxs = torch.where(pv, coords, -1e9).amax(dim=1)
    return torch.stack([mins, maxs], dim=1)


def compute_scene_range_and_boxes(batch: SceneBatch, voxel_size: float,
                                  mode_3d_center: str = "median"):
    """Scene [min, max] + GT instance centers/sizes (B, I, 3)."""
    rng = scene_range(batch, voxel_size)
    if batch.point_inst_ids is None:
        return rng, None, None
    coords = _scene_coords(batch, voxel_size)
    b = coords.shape[0]
    i_cap = batch.inst_labels.shape[1]
    ids = batch.point_inst_ids.long()
    valid = (batch.point_valid & (ids >= 0)).reshape(-1)
    seg = (torch.arange(b, device=ids.device)[:, None] * i_cap
           + ids.clamp(0, i_cap - 1)).reshape(-1)
    seg = torch.where(valid, seg, b * i_cap)     # dump slot
    flat = coords.reshape(-1, 3)
    idx = seg[:, None].expand(-1, 3)
    n_seg = b * i_cap + 1
    imin = flat.new_full((n_seg, 3), float("inf")).scatter_reduce(
        0, idx, flat, "amin")[:-1]
    imax = flat.new_full((n_seg, 3), float("-inf")).scatter_reduce(
        0, idx, flat, "amax")[:-1]
    cnt = torch.bincount(seg, minlength=n_seg)[:-1].reshape(b, i_cap)
    if mode_3d_center == "median":
        ctr = (imax + imin) / 2
    elif mode_3d_center == "mean":
        summ = flat.new_zeros(n_seg, 3).index_add_(0, seg, flat)[:-1]
        ctr = summ / cnt.reshape(-1, 1).clamp(min=1).to(flat.dtype)
    else:
        raise ValueError(mode_3d_center)
    has = (cnt > 0)[..., None]
    centers = torch.where(has, ctr.reshape(b, i_cap, 3), 0.0)
    sizes = torch.where(has, (imax - imin).reshape(b, i_cap, 3), 0.0)
    return rng, centers, sizes


def select_queries_random(sp_valid: torch.Tensor, query_thr: float,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random-permutation prefix selection: (query_sp_idx (B, S) int32,
    query_valid (B, S)).  The queries are a random permutation of the
    valid superpoints (invalid ones last), of which the first
    ``floor((thr + (1 - thr) u) * n_valid)`` are valid.  ``generator``
    draws the noise on its own device (the JAX package's ``jax.random``
    draws differ: tests hand both sides one selection)."""
    b, s = sp_valid.shape
    gdev = generator.device if generator is not None else sp_valid.device
    noise = torch.rand((b, s), generator=generator, device=gdev).to(
        sp_valid.device)
    noise = torch.where(sp_valid, noise, 2.0)
    order = torch.argsort(noise, dim=-1, stable=True).to(torch.int32)
    u = torch.rand((b,), generator=generator, device=gdev).to(sp_valid.device)
    frac = query_thr + (1 - query_thr) * u
    n_sel = torch.floor(frac * sp_valid.sum(-1)).to(torch.int32)
    qvalid = torch.arange(s, device=sp_valid.device)[None, :] < n_sel[:, None]
    return order, qvalid


def _gather_sp(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along the superpoint axis with (B, Q) indices."""
    idx = idx.long()
    if arr.dim() == 3:
        return torch.gather(arr, 1, idx[..., None].expand(-1, -1,
                                                           arr.shape[-1]))
    return torch.gather(arr, 1, idx)


class SegDINO3D(nn.Module):
    def __init__(self, backbone: nn.Module, decoder: nn.Module,
                 voxel_size: float = 0.02, query_thr: float = 0.5,
                 mode_3d_center: str = "median", query_num: int = -1,
                 add_positional_embedding: bool = True,
                 num_classes: int = 198):
        super().__init__()
        self.backbone = backbone
        self.decoder = decoder
        self.voxel_size = voxel_size
        self.query_thr = query_thr
        self.mode_3d_center = mode_3d_center
        self.query_num = query_num
        self.add_positional_embedding = add_positional_embedding
        self.num_classes = num_classes

    def select_queries(self, bb: BackboneOutput, queries=None,
                       generator: Optional[torch.Generator] = None):
        """(query_sp_idx (B, Q) int32 or None for every superpoint in
        order, query_valid (B, Q)).  With ``query_num > 0`` the top
        ``query_num`` superpoints by the decoder's ``score_superpoints``
        (a stable descending sort: ties keep the lower index first, as
        ``lax.top_k``; invalid ones score -1 and are not valid queries).
        Else in training mode ``queries`` where given, or the random
        selection with ``query_thr < 1``; else every superpoint."""
        if self.query_num > 0:
            with torch.no_grad():
                scores = torch.where(bb.sp_valid,
                                     self.decoder.score_superpoints(
                                         bb.sp_feats), -1.0)
            k = min(self.query_num, scores.shape[1])
            top, idx = torch.sort(scores, dim=-1, descending=True,
                                  stable=True)
            return idx[:, :k].to(torch.int32), top[:, :k] > -0.5
        if self.training:
            if queries is not None:
                return queries
            if self.query_thr < 1:
                return select_queries_random(bb.sp_valid, self.query_thr,
                                             generator)
        return None, bb.sp_valid

    def _decode(self, batch: SceneBatch, bb: BackboneOutput, rng, q_idx,
                q_valid, generator=None) -> Dict[str, Any]:
        if q_idx is None:
            feats, pos = bb.sp_feats, bb.sp_pos
        else:
            feats = _gather_sp(bb.sp_feats, q_idx)
            pos = _gather_sp(bb.sp_pos, q_idx)
        return self.decoder(
            sp_feats=bb.sp_feats, sp_valid=bb.sp_valid, sp_pos=bb.sp_pos,
            sp_pos_wo_elastic=bb.sp_pos_wo_elastic, queries_feat=feats,
            query_valid=q_valid,
            queries_pos=pos if self.add_positional_embedding else None,
            dinox_queries=batch.query2d_feats,
            dinox_query_pos=batch.query2d_pos,
            dinox_valid=batch.query2d_valid, scene_range=rng,
            generator=generator)

    def forward(self, batch: SceneBatch,
                queries: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        """Eval mode: the decoder outputs (``decode``).

        Training mode: ``(outputs, gt)``.  The queries are those of
        ``select_queries``: the top-k with ``query_num > 0``, else
        ``queries`` where given, else drawn from ``generator``, which also
        draws the decoder's dropout masks; ``gt`` holds the targets
        gathered to the selection, as the criterion reads them."""
        if not self.training:
            return self.decode(batch, self.backbone(batch))
        rng, centers, sizes = compute_scene_range_and_boxes(
            batch, self.voxel_size, self.mode_3d_center)
        bb = self.backbone(batch)
        b, s = bb.sp_valid.shape
        q_idx, q_valid = self.select_queries(bb, queries, generator)
        if q_idx is None:
            q_idx = torch.arange(s, dtype=torch.int32,
                                 device=rng.device).expand(b, s)
        outputs = self._decode(batch, bb, rng, q_idx, q_valid, generator)
        sem_sp = torch.argmax(batch.sp_sem_masks.to(torch.uint8), dim=1)
        gt = dict(
            labels=batch.inst_labels, gt_valid=batch.inst_valid,
            sp_masks=batch.sp_inst_masks,
            query_masks=torch.gather(
                batch.sp_inst_masks, 2,
                q_idx.long()[:, None, :].expand(
                    -1, batch.sp_inst_masks.shape[1], -1)),
            centers=centers, sizes=sizes, query_valid=q_valid,
            sp_valid=bb.sp_valid, query_sem_targets=_gather_sp(sem_sp, q_idx))
        outputs.update(scene_range=rng, sp_valid=bb.sp_valid,
                       query_sp_idx=q_idx,
                       sp_pos_wo_elastic=bb.sp_pos_wo_elastic,
                       plan_overflow=bb.overflow)
        return outputs, gt

    def decode(self, batch: SceneBatch, bb: BackboneOutput) -> Dict[str, Any]:
        """The eval forward's decoder half on the backbone's output: every
        valid superpoint a query, or the top-k with ``query_num > 0``."""
        rng = scene_range(batch, self.voxel_size)
        b, s = bb.sp_valid.shape
        q_idx, q_valid = self.select_queries(bb)
        outputs = self._decode(batch, bb, rng, q_idx, q_valid)
        if q_idx is None:
            q_idx = torch.arange(s, dtype=torch.int32,
                                 device=rng.device).expand(b, s)
        outputs["scene_range"] = rng
        outputs["sp_valid"] = bb.sp_valid
        outputs["query_sp_idx"] = q_idx
        outputs["sp_pos_wo_elastic"] = bb.sp_pos_wo_elastic
        outputs["plan_overflow"] = bb.overflow
        return outputs
