"""SDMGR, the spatial dual-modality graph reasoning model for KIE
(counterpart of ``tps_pp_tpu/models/kie/sdmgr.py``; the reference's
``kie/heads/sdmgr_head.py``, ``kie/losses/sdmgr_loss.py`` and
``kie/extractors/sdmgr.py``).

Each receipt is one padded graph: (max_nodes, max_chars) character indices
(0 pads), (max_nodes, max_nodes, 5) relation features and a node mask (a
node with a character). The JAX package ``vmap``s the head over graphs;
here a batch dimension runs through the same arithmetic: (B, N, L) texts
and (B, N, N, 5) relations. Float32; the LSTM is the port's float32
island (``Float32LSTM``). No hand-written kernel: the products are
``nn.Linear``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...registry import BACKBONES, HEADS, LOSSES
from ..layers import Float32LSTM, roi_align


def _guarded_l2(x: torch.Tensor) -> torch.Tensor:
    """``x * rsqrt(max(|x|^2, 1e-12))`` over the last axis: an all-zero
    row (a padded relation at init) stays 0 with a finite gradient."""
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=1e-12))


class BlockFusion(nn.Module):
    """The chunked low-rank bilinear fusion of the visual (``x0``) and
    text (``x1``) node features (the JAX ``BlockFusion``; the reference's
    ``Block`` with 8 chunks of rank 4): ``linear0`` / ``linear1`` to
    ``mm_dim``; per chunk c the products of ``merge_linears0.{c}`` and
    ``merge_linears1.{c}`` (``chunk * rank`` wide) summed over the rank;
    the chunks concatenated, then the signed square root of ``|z| +
    1e-12`` and the guarded L2 norm over the whole concat; ``linear_out``
    to ``out_dim``."""

    def __init__(self, input_dims=(64, 256), out_dim: int = 256,
                 mm_dim: int = 1024, chunks: int = 8, rank: int = 4):
        super().__init__()
        self.chunks, self.rank = chunks, rank
        self.chunk = mm_dim // chunks
        self.linear0 = nn.Linear(input_dims[0], mm_dim)
        self.linear1 = nn.Linear(input_dims[1], mm_dim)
        self.merge_linears0 = nn.ModuleList(
            nn.Linear(self.chunk, self.chunk * rank) for _ in range(chunks))
        self.merge_linears1 = nn.ModuleList(
            nn.Linear(self.chunk, self.chunk * rank) for _ in range(chunks))
        self.linear_out = nn.Linear(self.chunk * chunks, out_dim)

    def forward(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        h0 = self.linear0(x0)
        h1 = self.linear1(x1)
        zs = []
        for c, (m0, m1) in enumerate(zip(self.merge_linears0,
                                         self.merge_linears1)):
            sl = slice(c * self.chunk, (c + 1) * self.chunk)
            z = m0(h0[..., sl]) * m1(h1[..., sl])
            zs.append(z.reshape(*z.shape[:-1], self.rank, self.chunk)
                      .sum(-2))
        z = torch.cat(zs, dim=-1)
        z = torch.sign(z) * torch.sqrt(torch.abs(z) + 1e-12)
        return self.linear_out(_guarded_l2(z))


class GNNLayer(nn.Module):
    """One graph layer: the (B, N, N, 2D + E) pair tensor [node i, node j,
    edge ij], ``in_fc`` + ReLU, ``coef_fc``, a softmax over the neighbours
    j with self pairs and padded neighbours at -1e9 (a node with no valid
    neighbour keeps its self pair: ``tps_pp_tpu/models/kie/sdmgr.py:
    74-86``), the weighted sum, and the residual ``nodes + relu(out_fc)``.
    Returns (nodes (B, N, D), the pair features (B, N, N, D))."""

    def __init__(self, node_dim: int = 256, edge_dim: int = 256):
        super().__init__()
        self.in_fc = nn.Linear(2 * node_dim + edge_dim, node_dim)
        self.coef_fc = nn.Linear(node_dim, 1)
        self.out_fc = nn.Linear(node_dim, node_dim)

    def forward(self, nodes, edges, node_mask):
        B, N, D = nodes.shape
        pair = torch.cat([nodes[:, :, None].expand(B, N, N, D),
                          nodes[:, None].expand(B, N, N, D), edges], dim=-1)
        cat = F.relu(self.in_fc(pair))
        coefs = self.coef_fc(cat)
        eye = torch.eye(N, device=nodes.device, dtype=nodes.dtype)
        neighbours = (1 - eye)[None] * node_mask[:, None, :]   # (B, N, N)
        self_ok = (neighbours.sum(2, keepdim=True) < 0.5).to(eye.dtype) * \
            eye[None]
        mask = (neighbours + self_ok)[..., None]
        coefs = torch.where(mask > 0, coefs, torch.full_like(coefs, -1e9))
        attn = torch.softmax(coefs, dim=2)
        residual = (attn * cat).sum(dim=2)
        return nodes + F.relu(self.out_fc(residual)), cat


@HEADS.register_module()
class SDMGRHead(nn.Module):
    """SDMGR's head with MMOCR 0.4.0's module names: ``node_embed``
    (``nn.Embedding`` of the character indices, clipped at 0; its pad row
    is not pinned, as in JAX), ``rnn`` (one-directional LSTM, read at each
    node's last character), ``fusion`` (``BlockFusion``, with
    ``visual_modality``), ``edge_embed`` (then the guarded L2 norm),
    ``gnn_layers``, ``node_cls`` and ``edge_cls`` (on the last layer's pair
    features). (relations (B, N, N, edge_input), texts (B, N, L), visual
    (B, N, visual_dim) or None) -> (node logits (B, N, num_classes), edge
    logits (B, N * N, 2))."""

    def __init__(self, num_chars: int = 92, visual_dim: int = 64,
                 fusion_dim: int = 1024, node_input: int = 32,
                 node_embed: int = 256, edge_input: int = 5,
                 edge_embed: int = 256, num_gnn: int = 2,
                 num_classes: int = 26, visual_modality: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.node_embed = nn.Embedding(num_chars, node_input)
        self.rnn = Float32LSTM(node_input, node_embed, batch_first=True)
        if visual_modality:
            self.fusion = BlockFusion((visual_dim, node_embed), node_embed,
                                      fusion_dim)
        self.edge_embed = nn.Linear(edge_input, edge_embed)
        self.gnn_layers = nn.ModuleList(
            GNNLayer(node_embed, edge_embed) for _ in range(num_gnn))
        self.node_cls = nn.Linear(node_embed, num_classes)
        self.edge_cls = nn.Linear(node_embed, 2)

    def forward(self, relations, texts, visual=None):
        B, N, L = texts.shape
        char_mask = texts > 0
        node_mask = char_mask.any(-1).to(relations.dtype)
        emb = self.node_embed(texts.clamp(min=0).long())
        out, _ = self.rnn(emb.reshape(B * N, L, -1))
        lengths = char_mask.sum(-1).clamp(min=1).reshape(B * N)
        nodes = out[torch.arange(B * N, device=out.device), lengths - 1]
        nodes = nodes.reshape(B, N, -1).to(relations.dtype)
        if visual is not None:
            nodes = self.fusion(visual, nodes)
        edges = _guarded_l2(self.edge_embed(relations))
        cat = None
        for layer in self.gnn_layers:
            nodes, cat = layer(nodes, edges, node_mask)
        return (self.node_cls(nodes),
                self.edge_cls(cat).reshape(B, N * N, 2))


def roi_visual_pool(fm: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) feature maps and (B, N, 4) xyxy boxes in their
    coordinates -> (B, N, C): ``roi_align`` at 7x7, then the maximum over
    the bins (the JAX ``roi_visual_pool``, ``roi_align_jax`` over each
    image; the reference's extractor + max pool, ``sdmgr.py:96-100``)."""
    B, N = boxes.shape[:2]
    batch = torch.arange(B, device=fm.device).repeat_interleave(N)
    pooled = roi_align(fm.permute(0, 3, 1, 2), boxes.reshape(B * N, 4),
                       (7, 7), batch)
    return pooled.amax(dim=(2, 3)).reshape(B, N, -1)


class SDMGR(nn.Module):
    """The KIE model: ``head`` (``SDMGRHead``) and, with ``visual``, the
    ``backbone`` (the config's, UNet16 where it names none) whose map is
    pooled at each node's box into the head's fusion (the reference's
    ``extract_feat``)."""

    def __init__(self, model_cfg: Dict, visual: bool = False):
        super().__init__()
        self.visual = bool(visual)
        self.head = HEADS.build(model_cfg['head'],
                                visual_modality=self.visual)
        if self.visual:
            self.backbone = BACKBONES.build(
                model_cfg.get('backbone') or
                {'type': 'UNet', 'base_channels': 16})

    def visual_features(self, img: torch.Tensor,
                        boxes: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images, (B, N, 4) boxes -> (B, N, C)."""
        return roi_visual_pool(self.backbone(img), boxes)

    def forward(self, relations, texts, img=None, boxes=None):
        visual = self.visual_features(img, boxes) if self.visual else None
        return self.head(relations, texts, visual)


def _masked_ce(logits, targets, ignore):
    logp = torch.log_softmax(logits.float(), -1)
    tgt = targets.long().clamp(0, logits.shape[-1] - 1)
    nll = -torch.gather(logp, -1, tgt[:, None])[:, 0]
    mask = (targets != ignore).float()
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)


@LOSSES.register_module()
class SDMGRLoss:
    """Masked node and edge cross entropy (reference
    ``kie/losses/sdmgr_loss.py:10-60``): node targets ignore -100, edge
    targets -1; each the mean over the targets kept."""

    def __init__(self, node_weight=1.0, edge_weight=1.0, ignore=-100,
                 **kwargs):
        self.node_weight = node_weight
        self.edge_weight = edge_weight
        self.ignore = ignore

    def __call__(self, node_preds, edge_preds, node_gts, edge_gts
                 ) -> Dict[str, torch.Tensor]:
        return {
            'loss_node': self.node_weight * _masked_ce(
                node_preds, node_gts, self.ignore),
            'loss_edge': self.edge_weight * _masked_ce(
                edge_preds, edge_gts.reshape(-1), -1),
        }


def build_sdmgr(model_cfg: Dict, visual: Optional[bool] = None) -> SDMGR:
    """``SDMGR`` of a model config; ``visual`` defaults to the config's
    ``visual_modality``."""
    if visual is None:
        visual = bool(model_cfg.get('visual_modality'))
    return SDMGR(model_cfg, visual)
