"""Feature distillation loss, cosine + POD-spatial (counterpart of
``tps_pp_tpu/losses/kd.py``; reference ``losses/kd_loss.py:5-83``, which
the fork wires into training but ships commented out).

``kd_loss(teacher, student)``: the cosine-embedding distance between the
flattened features plus the v2 POD spatial term (channel-summed squared
energy maps, L2-normalised, mean Euclidean distance), in float32. NHWC
inputs; the teacher is detached.
"""
from __future__ import annotations

import torch

from ..registry import LOSSES

LAMBDA_F = 1.0
LAMBDA_C = 1.0


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def pod_spatial_loss_v2(teacher: torch.Tensor, student: torch.Tensor,
                        normalize: bool = True) -> torch.Tensor:
    """teacher / student: (N, H, W, C)."""
    a = teacher.square().sum(-1).reshape(teacher.shape[0], -1)
    b = student.square().sum(-1).reshape(student.shape[0], -1)
    if normalize:
        a, b = _l2_normalize(a), _l2_normalize(b)
    return torch.linalg.vector_norm(a - b, dim=-1).mean()


def kd_loss(teacher_features: torch.Tensor,
            student_features: torch.Tensor) -> torch.Tensor:
    """The scalar distillation loss; no gradient reaches the teacher."""
    t = teacher_features.detach().float()
    s = student_features.float()
    B = s.shape[0]
    tf = _l2_normalize(t.reshape(B, -1))
    sf = _l2_normalize(s.reshape(B, -1))
    cos = 1.0 - (tf * sf).sum(-1)                  # cosine embedding, y=1
    return cos.mean() * LAMBDA_F + pod_spatial_loss_v2(t, s) * LAMBDA_C


@LOSSES.register_module()
class KD_Loss:
    def __call__(self, teacher_features, student_features):
        return {'loss_kd': kd_loss(teacher_features, student_features)}
