"""DRRG, the Deep Relational Reasoning Graph detector (counterpart of
``tps_pp_tpu/models/textdet/drrg.py``).

Split as in the JAX package:

* on the card (``nn.Module``): ``DRRGHead``, a 1x1 convolution to six maps
  [text, centre, sin, cos, top height, bottom height] (``out_conv``; text
  and centre one logit each), and the relational classifier ``GCN``
  (``gcn``, MMOCR 0.4.0's names: ``conv1`` .. ``conv4``, each a
  ``GraphConv`` with a ``weight`` (2 in, out) over ``cat(x, A x)``, and
  ``classifier.0/1/2``: Linear(64, 32), PReLU(32), Linear(32, 2)). The
  GCN's input normalisation is JAX's, not the reference's
  ``BatchNorm1d``: the mean and biased variance of every node row of the
  batch, padded rows included, eps 1e-5, in train and eval mode alike.
* on the host (numpy): the text components proposed from the maps
  (``ProposalLocalGraphs.propose_comps``: the 8-connected centre regions,
  their skeletons, a quad at each skeleton pixel, ``poly_nms``), the
  k-hop local graphs (``LocalGraphs``), the rotated RoI pooling of the
  features and maps (``roi_align_rotated_np``, the JAX package's
  vectorised bilinear gather), the sinusoidal geometry embedding, and the
  clustering of the linked components into boundaries
  (``DRRGPostprocessor``: union-find over the links at ``link_thr``, the
  union of each cluster's quads rasterised by ``cv_ops.fill_poly``, its
  largest outer border by ``cv_ops.find_contours``). The graphs follow
  JAX's host order: neighbour lists from Python sets of numpy ints built
  by the same insertions, numpy's default ``argsort``.
* ``DRRGLoss``: balanced BCE with OHEM on the text map (the negative count
  truncated to int32, as JAX casts it), the centre map's BCE (text pixels,
  then 0.5 of the rest), smooth L1 of the heights (relative, weighted by
  log(height + 1)) and of the normalised sin / cos over the centre pixels,
  and the GCN's cross entropy over the links, labels -1 (padded graphs)
  ignored; float32, or float64 for a float64 model.

``DRRGModule`` is backbone -> neck -> (features, maps), NHWC at its
boundary; ``DRRGDetector`` runs the test graphs of one image's features
and maps (copied to the host), the GCN on the module's device and the
postprocessor. The link probability is JAX's ``exp(p1) / sum(exp(p))`` in
float32 on the host.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...datasets.pipelines import cv_ops
from ...registry import HEADS, LOSSES
from .fce_textsnake import _masked_mean, _smooth_l1, _top_negatives


# ------------------------------------------------------------- host utils --

def euclidean_distance_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(reference modules/utils.py:28-52)"""
    d2 = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] -
          2 * a @ b.T)
    return np.sqrt(np.maximum(d2, 0.0))


def normalize_adjacent_matrix(mat: np.ndarray) -> np.ndarray:
    """D^-1/2 (A+I) D^-1/2 (reference modules/utils.py:5-25)."""
    mat = mat + np.eye(mat.shape[0])
    d = np.clip(np.sum(mat, axis=0), 0, None)
    d_inv = np.power(d, -0.5).flatten()
    d_inv[np.isinf(d_inv)] = 0.0
    d_inv = np.diag(d_inv)
    return mat.dot(d_inv).transpose().dot(d_inv)


def feature_embedding(input_feats: np.ndarray, out_feat_len: int):
    """Sinusoidal geometric-feature embedding
    (reference modules/utils.py:55-107)."""
    num_nodes, feat_dim = input_feats.shape
    repeat = out_feat_len // feat_dim
    residue = out_feat_len % feat_dim
    if residue > 0:
        wave = np.array([np.power(1000, 2.0 * (j // 2) / repeat + 1)
                         for j in range(repeat + 1)]).reshape(-1, 1, 1)
        feats = np.repeat(input_feats[None], repeat, axis=0)
        residue_feats = np.hstack([
            input_feats[:, :residue],
            np.zeros((num_nodes, feat_dim - residue))])
        feats = np.concatenate([feats, residue_feats[None]], axis=0)
    else:
        wave = np.array([np.power(1000, 2.0 * (j // 2) / repeat)
                         for j in range(repeat)]).reshape(-1, 1, 1)
        feats = np.repeat(input_feats[None], repeat, axis=0)
    emb = feats / wave
    emb[:, 0::2] = np.sin(emb[:, 0::2])
    emb[:, 1::2] = np.cos(emb[:, 1::2])
    return np.transpose(emb, (1, 0, 2)).reshape(
        num_nodes, -1)[:, :out_feat_len].astype(np.float32)


def roi_align_rotated_np(feat: np.ndarray, rois: np.ndarray,
                         out_size: Tuple[int, int],
                         spatial_scale: float = 1.0) -> np.ndarray:
    """Rotated RoI pooling (mmcv's ``RoIAlignRotated`` in the reference,
    ``modules/local_graph.py``): feat (H, W, C); rois (N, 5) [cx, cy, w,
    h, angle (rad)]; (N, out_h, out_w, C) bilinear samples on each rotated
    grid, all RoIs in one gather."""
    H, W, C = feat.shape
    out_w, out_h = out_size
    n = len(rois)
    if n == 0:
        return np.zeros((0, out_h, out_w, C), np.float32)
    ys = (np.arange(out_h) + 0.5) / out_h - 0.5   # [-0.5, 0.5)
    xs = (np.arange(out_w) + 0.5) / out_w - 0.5
    gy, gx = np.meshgrid(ys, xs, indexing='ij')   # (oh, ow)
    cx, cy, w, h = (rois[:, i, None, None] * spatial_scale
                    for i in range(4))
    ang = rois[:, 4, None, None]
    cosa, sina = np.cos(ang), np.sin(ang)
    px = cx + gx[None] * w * cosa - gy[None] * h * sina   # (N, oh, ow)
    py = cy + gx[None] * w * sina + gy[None] * h * cosa
    x0 = np.clip(np.floor(px), 0, W - 1).astype(np.int32)
    y0 = np.clip(np.floor(py), 0, H - 1).astype(np.int32)
    x1 = np.clip(x0 + 1, 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    wx = np.clip(px - x0, 0, 1)[..., None]
    wy = np.clip(py - y0, 0, 1)[..., None]
    out = ((feat[y0, x0] * (1 - wx) + feat[y0, x1] * wx) * (1 - wy) +
           (feat[y1, x0] * (1 - wx) + feat[y1, x1] * wx) * wy)
    return out.astype(np.float32)


# ---------------------------------------------------------- the card: GCN --

class GraphConv(nn.Module):
    """relu(cat(x, A x) @ weight + bias) (reference gcn.py:15-34)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(2 * in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        nn.init.xavier_uniform_(self.weight)

    def forward(self, x, adj):
        cat = torch.cat([x, torch.bmm(adj, x)], dim=-1)
        return F.relu(cat @ self.weight + self.bias)


class GCN(nn.Module):
    """Four graph convolutions and the edge classifier (reference
    gcn.py:37-76), the input normalised over every node row of the batch
    (JAX's, in every mode)."""

    def __init__(self, feat_len: int):
        super().__init__()
        self.conv1 = GraphConv(feat_len, 512)
        self.conv2 = GraphConv(512, 256)
        self.conv3 = GraphConv(256, 128)
        self.conv4 = GraphConv(128, 64)
        self.classifier = nn.Sequential(nn.Linear(64, 32), nn.PReLU(32),
                                        nn.Linear(32, 2))

    def forward(self, x, adj, knn_inds):
        """x (G, N, D), adj (G, N, N), knn_inds (G, K) into N -> the link
        logits (G K, 2)."""
        G, N, D = x.shape
        dtype = self.conv1.weight.dtype
        flat = x.reshape(-1, D).to(torch.promote_types(dtype, torch.float32))
        mu = flat.mean(0, keepdim=True)
        var = flat.var(0, unbiased=False, keepdim=True)
        x = ((flat - mu) / torch.sqrt(var + 1e-5)).reshape(G, N, D).to(dtype)
        adj = adj.to(dtype)
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            x = conv(x, adj)
        idx = knn_inds.long()[..., None].expand(-1, -1, x.shape[-1])
        edge = torch.gather(x, 1, idx).reshape(-1, x.shape[-1])
        return self.classifier(edge)


@HEADS.register_module()
class DRRGHead(nn.Module):
    """``out_conv``, a 1x1 convolution to the six maps (reference
    drrg_head.py:124-130, text and centre one logit each), and ``gcn`` on
    node features of ``pooling_output_size`` samples of the features and
    maps plus ``node_geo_feat_len`` of embedded geometry."""

    def __init__(self, in_channels: int = 32, out_channels: int = 6,
                 pooling_output_size=(4, 3), node_geo_feat_len: int = 120,
                 **kwargs):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        pw, ph = pooling_output_size
        self.node_feat_len = (pw * ph * (in_channels + out_channels)
                              + node_geo_feat_len)
        self.out_conv = nn.Conv2d(in_channels, out_channels, 1)
        self.gcn = GCN(self.node_feat_len)

    def forward(self, x):
        return self.out_conv(x)


# ------------------------------------------------------ host: local graphs --

class LocalGraphs:
    """k-hop local-graph construction (reference local_graph.py:10-297),
    with the rotated RoI pooling for content features."""

    def __init__(self, k_at_hops=(8, 4), num_adjacent_linkages=3,
                 node_geo_feat_len=120, pooling_scale=1.0,
                 pooling_output_size=(4, 3), local_graph_thr=0.7):
        self.k_at_hops = k_at_hops
        self.num_adjacent_linkages = num_adjacent_linkages
        self.node_geo_feat_dim = node_geo_feat_len
        self.pooling_scale = pooling_scale
        self.pooling_output_size = pooling_output_size
        self.local_graph_thr = local_graph_thr

    @property
    def pad_nodes(self) -> int:
        """The most nodes a local graph can hold, ``1 + k0 (1 + k1)``."""
        return 1 + self.k_at_hops[0] * (1 + self.k_at_hops[1])

    def generate_local_graphs(self, sorted_dist_inds, labels):
        """(reference local_graph.py:47-114)"""
        knn_graph = sorted_dist_inds[:, 1:self.k_at_hops[0] + 1]
        pivot_local_graphs, pivot_knns = [], []
        for pivot_ind, knn in enumerate(knn_graph):
            neighbors = set(knn)
            for n_ind in knn:
                neighbors.update(
                    set(sorted_dist_inds[n_ind, 1:self.k_at_hops[1] + 1]))
            neighbors.discard(pivot_ind)
            local_graph = [pivot_ind] + list(neighbors)
            pivot_knn = [pivot_ind] + list(knn)
            add_flag = True
            if pivot_ind >= 1 and labels is not None:
                for g_ind, added_knn in enumerate(pivot_knns):
                    added_pivot = added_knn[0]
                    added_graph = pivot_local_graphs[g_ind]
                    union = len(set(local_graph[1:]) | set(added_graph[1:]))
                    inter = len(set(local_graph[1:]) & set(added_graph[1:]))
                    iou = inter / (union + 1e-8)
                    if (iou > self.local_graph_thr and pivot_ind in added_knn
                            and labels[added_pivot] == labels[pivot_ind]
                            and labels[pivot_ind] != 0):
                        add_flag = False
                        break
            if add_flag:
                pivot_local_graphs.append(local_graph)
                pivot_knns.append(pivot_knn)
        return pivot_local_graphs, pivot_knns

    def node_features(self, feat_map: np.ndarray, geo_attribs: np.ndarray):
        """Content (rotated RoI) and embedded geometric features; feat_map
        (H, W, C), geo_attribs (n, 6) [x, y, h, w, cos, sin]."""
        cosv = np.clip(geo_attribs[:, 4], -1, 1)
        angle = np.arccos(cosv) * np.sign(geo_attribs[:, 5])
        rois = np.hstack([geo_attribs[:, 0:4], angle.reshape(-1, 1)])
        content = roi_align_rotated_np(feat_map, rois,
                                       self.pooling_output_size,
                                       self.pooling_scale)
        content = content.reshape(len(rois), -1)
        geo = feature_embedding(geo_attribs, self.node_geo_feat_dim)
        return np.hstack([content, geo]).astype(np.float32)

    def build(self, feat_map: np.ndarray, comp_attribs: np.ndarray,
              pad_nodes: int = None, pad_graphs: int = None):
        """comp_attribs (n, 7) [x, y, h, w, cos, sin, label] -> ``pack``'s
        GCN inputs and link labels; ``pad_nodes`` / ``pad_graphs`` pad the
        graphs (padded graphs' links are -1, which the loss ignores)."""
        geo = comp_attribs[:, 0:6].astype(np.float32)
        labels = comp_attribs[:, 6].astype(np.int32)
        centers = geo[:, 0:2]
        dist = euclidean_distance_matrix(centers, centers)
        sorted_dist_inds = np.argsort(dist, axis=1)
        graphs, knns = self.generate_local_graphs(sorted_dist_inds, labels)
        node_feats = self.node_features(feat_map, geo)
        return self.pack(node_feats, sorted_dist_inds, graphs, knns, labels,
                         pad_nodes=pad_nodes, pad_graphs=pad_graphs)

    def pack(self, node_feats, sorted_dist_inds, graphs, knns, labels=None,
             pad_nodes: int = None, pad_graphs: int = None):
        """The graphs padded to a common node count: (feats (G, N, D), adj
        (G, N, N), knn_inds (G, K), link labels (G K,) or None, graphs,
        knns) (reference local_graph.py:116-222)."""
        num_max = max(len(g) for g in graphs)
        if pad_nodes is not None:
            assert pad_nodes >= num_max, (pad_nodes, num_max)
            num_max = pad_nodes
        feats, adjs, knn_out, links = [], [], [], []
        for graph, knn in zip(graphs, knns):
            n = len(graph)
            node2ind = {j: i for i, j in enumerate(graph)}
            knn_inds = np.array([node2ind[i] for i in knn[1:]], np.int32)
            pivot_feat = node_feats[graph[0]]
            normalized = node_feats[graph] - pivot_feat
            adj = np.zeros((n, n), np.float32)
            for node in graph:
                for neighbor in sorted_dist_inds[
                        node, 1:self.num_adjacent_linkages + 1]:
                    if neighbor in node2ind:
                        adj[node2ind[node], node2ind[neighbor]] = 1
                        adj[node2ind[neighbor], node2ind[node]] = 1
            adj = normalize_adjacent_matrix(adj)
            pad_adj = np.zeros((num_max, num_max), np.float32)
            pad_adj[:n, :n] = adj
            pad_feat = np.zeros((num_max, node_feats.shape[1]), np.float32)
            pad_feat[:n] = normalized
            feats.append(pad_feat)
            adjs.append(pad_adj)
            knn_out.append(knn_inds)
            if labels is not None:
                graph_labels = labels[graph]
                knn_labels = graph_labels[knn_inds]
                links.append(((labels[graph[0]] == knn_labels) &
                              (labels[graph[0]] > 0)).astype(np.int32))
        K = len(knns[0]) - 1
        if pad_graphs is not None and pad_graphs > len(graphs):
            D = node_feats.shape[1]
            for _ in range(pad_graphs - len(graphs)):
                feats.append(np.zeros((num_max, D), np.float32))
                adjs.append(np.zeros((num_max, num_max), np.float32))
                knn_out.append(np.zeros((K,), np.int32))
                if labels is not None:
                    links.append(np.full((K,), -1, np.int32))
        out_links = np.concatenate(links) if labels is not None else None
        return (np.stack(feats), np.stack(adjs),
                np.stack(knn_out).astype(np.int32), out_links, graphs, knns)


class ProposalLocalGraphs(LocalGraphs):
    """Test-time text components proposed from the predicted maps, and
    their local graphs (reference proposal_local_graph.py)."""

    def __init__(self, k_at_hops=(8, 4), num_adjacent_linkages=3,
                 node_geo_feat_len=120, pooling_scale=1.0,
                 pooling_output_size=(4, 3), nms_thr=0.3, min_width=8.0,
                 max_width=24.0, comp_shrink_ratio=1.03, comp_w_h_ratio=0.4,
                 comp_score_thr=0.3, text_region_thr=0.2,
                 center_region_thr=0.2, center_region_area_thr=50):
        super().__init__(k_at_hops, num_adjacent_linkages, node_geo_feat_len,
                         pooling_scale, pooling_output_size, 1.0)
        self.nms_thr = nms_thr
        self.min_width = min_width
        self.max_width = max_width
        self.comp_shrink_ratio = comp_shrink_ratio
        self.comp_w_h_ratio = comp_w_h_ratio
        self.comp_score_thr = comp_score_thr
        self.text_region_thr = text_region_thr
        self.center_region_thr = center_region_thr
        self.center_region_area_thr = center_region_area_thr

    def propose_comps(self, pred_maps: np.ndarray):
        """pred_maps (H, W, 6) raw -> text components (n, 9) [8 corners,
        score] and their geometry (n, 6), or (None, None)."""
        from .postprocess import poly_nms
        from .sidelines import skeletonize

        text_score = 1 / (1 + np.exp(-pred_maps[..., 0]))
        center_score = 1 / (1 + np.exp(-pred_maps[..., 1])) * text_score
        sin_p, cos_p = pred_maps[..., 2], pred_maps[..., 3]
        scale = np.sqrt(1.0 / (sin_p ** 2 + cos_p ** 2 + 1e-8))
        sin_p, cos_p = sin_p * scale, cos_p * scale
        top_h, bot_h = pred_maps[..., 4], pred_maps[..., 5]

        center_mask = ((center_score > self.center_region_thr) &
                       (text_score > self.text_region_thr)).astype(np.uint8)
        n_comp, labels_cc = cv_ops.connected_components(center_mask,
                                                        connectivity=8)
        comps = []
        for lab in range(1, n_comp):
            region = labels_cc == lab
            if region.sum() < self.center_region_area_thr:
                continue
            skel = skeletonize(region)
            ys, xs = np.nonzero(skel if skel.any() else region)
            for y, x in zip(ys, xs):
                th = max(float(top_h[y, x]), 1.0) * self.comp_shrink_ratio
                bh = max(float(bot_h[y, x]), 1.0) * self.comp_shrink_ratio
                s, c = float(sin_p[y, x]), float(cos_p[y, x])
                # sin / cos are the centre line's tangent: the top at
                # +th (s, -c), the bottom at -bh (s, -c), the corners
                # +-r (c, s) along the tangent
                top_mid = np.array([x + th * s, y - th * c])
                bot_mid = np.array([x - bh * s, y + bh * c])
                width = np.clip((th + bh) * self.comp_w_h_ratio,
                                self.min_width, self.max_width)
                r = width / 2
                dx, dy = c * r, s * r
                tl = top_mid + [-dx, -dy]
                tr = top_mid + [dx, dy]
                br = bot_mid + [dx, dy]
                bl = bot_mid + [-dx, -dy]
                score = float(center_score[y, x])
                if score < self.comp_score_thr:
                    continue
                comps.append(np.hstack([tl, tr, br, bl, [score]]))
        if not comps:
            return None, None
        comps = poly_nms([c.tolist() for c in comps], self.nms_thr)
        comps = np.asarray(comps, np.float32)
        centers = comps[:, 0:8].reshape(-1, 4, 2).mean(axis=1)
        cx = np.clip(centers[:, 0].astype(np.int32), 0,
                     pred_maps.shape[1] - 1)
        cy = np.clip(centers[:, 1].astype(np.int32), 0,
                     pred_maps.shape[0] - 1)
        h = (top_h[cy, cx] + bot_h[cy, cx]) * self.comp_shrink_ratio
        w = np.clip(h * self.comp_w_h_ratio, self.min_width, self.max_width)
        geo = np.stack([centers[:, 0], centers[:, 1], np.maximum(h, 1.0), w,
                        cos_p[cy, cx], sin_p[cy, cx]], axis=1)
        return comps, geo.astype(np.float32)

    def build_test(self, pred_maps: np.ndarray, feat_map: np.ndarray):
        """(feats, adj, knn_inds, graphs, knns, comps) of one image, or
        None where fewer than two components are proposed."""
        comps, geo = self.propose_comps(pred_maps)
        if comps is None or len(comps) < 2:
            return None
        dist = euclidean_distance_matrix(geo[:, 0:2], geo[:, 0:2])
        sorted_dist_inds = np.argsort(dist, axis=1)
        k = min(self.k_at_hops[0], len(comps) - 1)
        knn_graph = sorted_dist_inds[:, 1:k + 1]
        graphs, knns = [], []
        for pivot_ind, knn in enumerate(knn_graph):
            neighbors = set(knn)
            for n_ind in knn:
                neighbors.update(set(
                    sorted_dist_inds[n_ind,
                                     1:min(self.k_at_hops[1],
                                           len(comps) - 1) + 1]))
            neighbors.discard(pivot_ind)
            graphs.append([pivot_ind] + list(neighbors))
            knns.append([pivot_ind] + list(knn))
        node_feats = self.node_features(feat_map, geo)
        feats, adjs, knn_inds, _, graphs, knns = self.pack(
            node_feats, sorted_dist_inds, graphs, knns, None)
        return feats, adjs, knn_inds, graphs, knns, comps


# -------------------------------------------------------------------- loss --

@LOSSES.register_module()
class DRRGLoss:
    """The JAX ``DRRGLoss`` (reference losses/drrg_loss.py:12-253): preds
    (N, H, W, 6) raw maps; targets ``gt_text_mask``,
    ``gt_center_region_mask``, ``gt_mask``, ``gt_top_height_map``,
    ``gt_bot_height_map``, ``gt_sin_map``, ``gt_cos_map``, each (N, H, W);
    with ``gcn_pred`` (L, 2) and ``gt_links`` (L,) also ``loss_gcn``."""

    def __init__(self, ohem_ratio=3.0, **kwargs):
        self.ohem_ratio = ohem_ratio

    def _balanced_bce(self, prob, gt, mask):
        gt, mask, prob = gt.reshape(-1), mask.reshape(-1), prob.reshape(-1)
        eps = 1e-6
        loss = -(gt * torch.log(prob + eps)
                 + (1 - gt) * torch.log(1 - prob + eps))
        pos = gt * mask
        neg = (1 - gt) * mask
        n_pos = pos.sum()
        n_neg = torch.minimum(neg.sum(), torch.clamp(
            n_pos * self.ohem_ratio, min=100.0)).int()
        return ((loss * pos).sum() + _top_negatives(loss, neg > 0, n_neg)) / (
            n_pos + n_neg.to(loss.dtype) + 1e-5)

    @staticmethod
    def gcn_loss(gcn_pred, gt_labels):
        """Cross entropy over the links; labels below 0 (padded graphs)
        are ignored."""
        logp = F.log_softmax(
            gcn_pred.to(torch.promote_types(gcn_pred.dtype, torch.float32)),
            dim=-1)
        labels = gt_labels.reshape(-1).long()
        mask = (labels >= 0).to(logp.dtype)
        nll = -logp.gather(1, labels.clamp(min=0)[:, None])[:, 0]
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    def __call__(self, preds, targets, gcn_pred=None, gt_links=None
                 ) -> Dict[str, torch.Tensor]:
        # float32, or float64 for a float64 model
        p = preds.to(torch.promote_types(preds.dtype, torch.float32))
        pred_text = torch.sigmoid(p[..., 0])
        pred_center = torch.sigmoid(p[..., 1])
        pred_sin, pred_cos = p[..., 2], p[..., 3]
        pred_top, pred_bot = p[..., 4], p[..., 5]
        scale = torch.sqrt(1.0 / (pred_sin ** 2 + pred_cos ** 2 + 1e-8))
        pred_sin, pred_cos = pred_sin * scale, pred_cos * scale

        gt = {k: targets[k].to(p.dtype) for k in (
            'gt_text_mask', 'gt_center_region_mask', 'gt_mask',
            'gt_top_height_map', 'gt_bot_height_map', 'gt_sin_map',
            'gt_cos_map')}
        gt_text, gt_center = gt['gt_text_mask'], gt['gt_center_region_mask']
        gt_mask = gt['gt_mask']
        gt_top, gt_bot = gt['gt_top_height_map'], gt['gt_bot_height_map']

        loss_text = self._balanced_bce(pred_text, gt_text, gt_mask)
        text_mask = gt_text * gt_mask
        neg_text_mask = (1 - gt_text) * gt_mask
        eps = 1e-6
        bce_center = -(gt_center * torch.log(pred_center + eps)
                       + (1 - gt_center) * torch.log(1 - pred_center + eps))
        loss_center = (_masked_mean(bce_center, text_mask)
                       + 0.5 * _masked_mean(bce_center, neg_text_mask))
        center_mask = gt_center * gt_mask
        ones = torch.ones_like(pred_top)
        loss_top = _smooth_l1(pred_top / (gt_top + 1e-2), ones)
        loss_bot = _smooth_l1(pred_bot / (gt_bot + 1e-2), ones)
        loss_height = _masked_mean(
            torch.log(gt_top + gt_bot + 1) * (loss_top + loss_bot),
            center_mask)
        loss_sin = _masked_mean(_smooth_l1(pred_sin, gt['gt_sin_map']),
                                center_mask)
        loss_cos = _masked_mean(_smooth_l1(pred_cos, gt['gt_cos_map']),
                                center_mask)
        out = {'loss_text': loss_text, 'loss_center': loss_center,
               'loss_height': loss_height, 'loss_sin': loss_sin,
               'loss_cos': loss_cos}
        if gcn_pred is not None and gt_links is not None:
            out['loss_gcn'] = self.gcn_loss(gcn_pred, gt_links)
        return out


# ------------------------------------------------------------ postprocess --

class DRRGPostprocessor:
    """Cluster the text components along their links and draw each
    cluster's boundary (reference drrg_postprocessor.py and
    postprocess/utils.py:184-268,433+; the boundary is the largest outer
    border of the rasterised union of the cluster's quads)."""

    def __init__(self, link_thr=0.8, edge_len_thr=50.0, **kwargs):
        self.link_thr = link_thr
        self.edge_len_thr = edge_len_thr

    def __call__(self, edges, scores, text_comps) -> List[np.ndarray]:
        if edges is None or len(edges) == 0:
            return []
        edges = np.sort(np.asarray(edges), axis=1)
        scores = np.asarray(scores, np.float32).copy()
        n = text_comps.shape[0]
        # over-long edges lose their score (graph_propagation,
        # utils.py:206-216); an edge seen twice averages
        score_map: Dict[Tuple[int, int], float] = {}
        for i, (a, b) in enumerate(edges):
            c1 = text_comps[a, :8].reshape(4, 2).mean(0)
            c2 = text_comps[b, :8].reshape(4, 2).mean(0)
            if np.linalg.norm(c1 - c2) > self.edge_len_thr:
                scores[i] = 0
            key = (int(a), int(b))
            score_map[key] = (0.5 * (score_map[key] + scores[i])
                              if key in score_map else float(scores[i]))
        parent = list(range(n))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for (a, b), s in score_map.items():
            if s >= self.link_thr:
                ra, rb = find(a), find(b)
                if ra != rb:
                    parent[ra] = rb
        clusters: Dict[int, List[int]] = {}
        for i in range(n):
            clusters.setdefault(find(i), []).append(i)
        boundaries = []
        for members in clusters.values():
            if len(members) < 2:  # remove_single (utils.py:296-323)
                continue
            quads = text_comps[members, :8].reshape(-1, 4, 2)
            score = float(text_comps[members, 8].mean())
            x_max = int(quads[..., 0].max()) + 3
            y_max = int(quads[..., 1].max()) + 3
            mask = np.zeros((y_max, x_max), np.uint8)
            for q in quads:
                cv_ops.fill_poly(mask, [np.clip(q, 0, None).astype(np.int32)],
                                 1)
            cs = cv_ops.find_contours(mask, cv_ops.RETR_EXTERNAL,
                                      cv_ops.CHAIN_APPROX_SIMPLE)
            if not cs:
                continue
            cont = max(cs, key=cv_ops.contour_area)
            if cont.size <= 8:
                continue
            boundaries.append(np.asarray(
                cont.flatten().tolist() + [score], np.float32))
        return boundaries


# ----------------------------------------------------- module and detector --

class DRRGModule(nn.Module):
    """backbone -> neck -> DRRGHead; NHWC image in, (the neck's features
    (N, H, W, C), the six maps (N, H, W, 6)) NHWC out, both at the
    image's size."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.head = head

    def forward(self, img: torch.Tensor):
        f = self.neck(self.backbone(img))
        return f.permute(0, 2, 3, 1), self.head(f).permute(0, 2, 3, 1)


class DRRGDetector:
    """One image's boundaries from its features and maps on the host
    (``feat_cat`` (H, W, C + 6), the features first): the test graphs
    (``ProposalLocalGraphs.build_test``), the GCN on its device, the link
    probabilities on the host and ``DRRGPostprocessor`` (the JAX
    ``DRRGDetector.detect`` for one image)."""

    def __init__(self, gcn: GCN, postprocessor: DRRGPostprocessor = None):
        self.gcn = gcn
        self.postprocessor = postprocessor or DRRGPostprocessor()
        self.graph_test = ProposalLocalGraphs()

    @torch.no_grad()
    def link_probs(self, node_feats, adjs, knn_inds) -> np.ndarray:
        """The GCN's probability of each link, (G K,) float32."""
        w = self.gcn.conv1.weight
        pred = self.gcn(torch.from_numpy(node_feats).to(w.device),
                        torch.from_numpy(adjs).to(w.device),
                        torch.from_numpy(knn_inds).to(w.device))
        pred = pred.float().cpu().numpy()
        return np.exp(pred[:, 1]) / np.exp(pred).sum(-1)

    def __call__(self, feat_cat: np.ndarray) -> List[np.ndarray]:
        data = self.graph_test.build_test(feat_cat[..., -6:], feat_cat)
        if data is None:
            return []
        node_feats, adjs, knn_inds, graphs, knns, comps = data
        probs = self.link_probs(node_feats, adjs, knn_inds)
        edges, scores = [], []
        k = knn_inds.shape[1]
        for g_ind, graph in enumerate(graphs):
            for k_ind in range(k):
                edges.append([graph[0], graph[int(knn_inds[g_ind, k_ind])]])
                scores.append(probs[g_ind * k + k_ind])
        return self.postprocessor(np.asarray(edges), np.asarray(scores),
                                  comps)
