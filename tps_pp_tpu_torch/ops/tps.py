"""Thin-plate-spline math of TPS++ (counterpart of ``tps_pp_tpu/ops/tps.py``).

The static matrices (fiducials C, inverted system matrix inv_delta_C, RBF
matrix P_hat, target pixels P) are numpy copies of the JAX package's builders,
bit-equal to them; ``build_P_prime`` is the per-batch grid generation in torch.
Conventions (reference tps_pp.py): fiducials and pixels at cell centres in
[0,1], kernel ``r^2 log(r + eps)`` for P_hat, ``fill_diagonal(1)`` before
``r^2 log r`` for the C-C distances.
"""
from __future__ import annotations

import numpy as np
import torch

THETA = 0.5  # score-modulation strength (reference thela, tps_pp.py:342)


def build_C_cell_centers(point_size) -> np.ndarray:
    """(point_y*point_x, 2) fiducial cell centres in [0,1], row-major over
    (y, x); last dim (x, y)."""
    py, px = point_size
    cx = (np.linspace(0.5, px - 0.5, num=int(px)) / px)
    cy = (np.linspace(0.5, py - 0.5, num=int(py)) / py)
    return np.stack(np.meshgrid(cx, cy), axis=2).reshape(-1, 2)


def tps_kernel_matrix_C(C: np.ndarray) -> np.ndarray:
    """(F, F) pairwise r^2 log r with the diagonal distance forced to 1."""
    d = np.linalg.norm(C[:, None, :] - C[None, :, :], axis=2)
    np.fill_diagonal(d, 1.0)
    return (d ** 2) * np.log(d)


def build_inv_delta_C(C: np.ndarray) -> np.ndarray:
    """Inverse of the (F+3, F+3) TPS system matrix."""
    F = C.shape[0]
    hat_C = tps_kernel_matrix_C(C)
    delta_C = np.concatenate([
        np.concatenate([np.ones((F, 1)), C, hat_C], axis=1),
        np.concatenate([np.zeros((2, 3)), C.T], axis=1),
        np.concatenate([np.zeros((1, 3)), np.ones((1, F))], axis=1),
    ], axis=0)
    return np.linalg.inv(delta_C)


def build_P_cell_centers(width: int, height: int) -> np.ndarray:
    """(H*W, 2) target pixel cell centres in [0,1], row-major (y, x), last
    dim (x, y)."""
    gx = np.linspace(0.5, width - 0.5, num=int(width)) / width
    gy = np.linspace(0.5, height - 0.5, num=int(height)) / height
    return np.stack(np.meshgrid(gx, gy), axis=2).reshape(-1, 2)


def build_P_hat(C: np.ndarray, P: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """(n, F) RBF matrix r^2 * log(r + eps)."""
    diff = P[:, None, :] - C[None, :, :]
    r = np.linalg.norm(diff, ord=2, axis=2)
    return np.square(r) * np.log(r + eps)


def build_P_prime(control_points: torch.Tensor, pc_score: torch.Tensor,
                  inv_delta_C: torch.Tensor, P_hat: torch.Tensor,
                  P: torch.Tensor, theta: float = THETA) -> torch.Tensor:
    """Attention-enhanced TPS grid (reference tps_pp.py:467-496).

    control_points (N, F, 2); pc_score (N, n, F); inv_delta_C (F+3, F+3);
    P_hat (n, F); P (n, 2). Returns the (N, n, 2) sampling grid P' in the
    dtype of ``control_points``."""
    N = control_points.shape[0]
    n = P_hat.shape[0]
    dt = control_points.dtype
    P_hat_mod = P_hat[None] * (pc_score * theta + 1.0)
    ones = control_points.new_ones((N, n, 1))
    P_b = P[None].to(dt).expand(N, n, 2)
    P_hat_full = torch.cat([ones, P_b, P_hat_mod.to(dt)], dim=2)
    Cp = torch.cat([control_points, control_points.new_zeros((N, 3, 2))],
                   dim=1)
    T = torch.einsum('ij,njk->nik', inv_delta_C.to(dt), Cp)
    return torch.bmm(P_hat_full, T)
