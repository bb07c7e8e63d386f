"""Viewpoint-invariant coordinate transform (VI-PointConv, X. Li et al.,
WACV 2023): per neighbour, 9 rotation/scale-invariant scalars followed by
the raw localized coordinates, 12 dims in all. The same arithmetic as
pcf_tpu/ops/vi_transform.VI_coordinate_transform.

The `*_flat` functions take and return the k-major flat layout [M, K*c]
(lane k*c + c') of pcf_tpu's flat stage geometry. pcf_tpu computes them with
constant 0/1 selection matrices, a TPU lane trick; here they are the same
arithmetic on [M, K, c] views. The `*_cm` functions take and return the
channel-major layout [c, M, K] of pcf_tpu's cm_geom stage geometry
(pcf_tpu/ops/vi_transform.py:233-279), the same arithmetic on permuted
views.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _normalize(x: torch.Tensor) -> torch.Tensor:
    # x / max(||x||, eps), as torch.nn.functional.normalize
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(_EPS)


def VI_coordinate_transform(localized_xyz: torch.Tensor,
                            gathered_norm: torch.Tensor,
                            sparse_xyz_norm: torch.Tensor) -> torch.Tensor:
    """localized_xyz [..., M, K, 3] (neighbour - centre), gathered_norm
    [..., M, K, 3] (neighbour normals), sparse_xyz_norm [..., M, 3] (centre
    normals) -> [..., M, K, 12]: theta1..theta9, then localized_xyz."""
    n_s = sparse_xyz_norm.unsqueeze(-2)                      # [..., M, 1, 3]
    r_hat = _normalize(localized_xyz)
    ns_dot_r = (n_s * r_hat).sum(-1, keepdim=True)           # [..., M, K, 1]
    v_miu = _normalize(n_s - ns_dot_r * r_hat)
    w_miu = _normalize(torch.linalg.cross(r_hat, v_miu, dim=-1))

    theta1 = (gathered_norm * n_s).sum(-1)
    theta2 = ns_dot_r.squeeze(-1)
    theta3 = (r_hat * gathered_norm).sum(-1)
    theta4 = (localized_xyz * n_s).sum(-1)
    theta5 = (gathered_norm * r_hat).sum(-1)  # duplicates theta3, as the reference
    theta6 = (gathered_norm * v_miu).sum(-1)
    theta7 = (gathered_norm * w_miu).sum(-1)
    theta8 = (localized_xyz * torch.linalg.cross(
        gathered_norm, n_s.expand_as(gathered_norm), dim=-1)).sum(-1)
    theta9 = torch.linalg.vector_norm(localized_xyz, dim=-1)
    thetas = torch.stack([theta1, theta2, theta3, theta4, theta5, theta6,
                          theta7, theta8, theta9], dim=-1)
    return torch.cat([thetas, localized_xyz], dim=-1)


def split_geom_flat(flat6: torch.Tensor):
    """k-major [M, K*6] xyz|normal rows -> ([M, K*3] xyz, [M, K*3] normals), f32."""
    M = flat6.shape[0]
    g = flat6.float().reshape(M, -1, 6)
    return g[..., :3].reshape(M, -1), g[..., 3:].reshape(M, -1)


def localize_flat(gathered_xyz_flat: torch.Tensor, center_xyz: torch.Tensor) -> torch.Tensor:
    """[M, K*3] gathered coordinates minus their centres [M, 3]."""
    M = gathered_xyz_flat.shape[0]
    g = gathered_xyz_flat.reshape(M, -1, 3)
    return (g - center_xyz.float()[:, None, :]).reshape(M, -1)


def vi_transform_flat(loc_flat: torch.Tensor, gn_flat: torch.Tensor,
                      center_norm: torch.Tensor) -> torch.Tensor:
    """VI features in flat layout: [M, K*3] offsets and neighbour normals,
    [M, 3] centre normals -> [M, K*12], per k theta1..9 then the offset."""
    M = loc_flat.shape[0]
    vi = VI_coordinate_transform(loc_flat.float().reshape(M, -1, 3),
                                 gn_flat.float().reshape(M, -1, 3), center_norm.float())
    return vi.reshape(M, -1)


def localize_cm(gathered_xyz_cm: torch.Tensor, center_xyz: torch.Tensor) -> torch.Tensor:
    """[3, M, K] gathered coordinates minus their centres [M, 3]."""
    return gathered_xyz_cm - center_xyz.T[:, :, None]


def vi_transform_cm(localized_cm: torch.Tensor, gathered_norm_cm: torch.Tensor,
                    sparse_xyz_norm: torch.Tensor) -> torch.Tensor:
    """VI features channel-major: [3, M, K] offsets and neighbour normals,
    [M, 3] centre normals -> [12, M, K], rows theta1..9 then the offset."""
    vi = VI_coordinate_transform(localized_cm.permute(1, 2, 0),
                                 gathered_norm_cm.permute(1, 2, 0), sparse_xyz_norm)
    return vi.permute(2, 0, 1)
