"""SDF training losses (port of nerfloam_tpu/core/losses.py, single device).

Free-space loss pushes the sdf to +1 in front of the measured surface;
the truncated-SDF loss pushes z + sdf * trunc to the measured distance
inside the band; count-balancing weights come from the batch's own sample
counts; z and d are scaled by the ground-normal cosine.
"""

from __future__ import annotations

import torch

from nerfloam_tpu_torch.ops.ieee import norm3

MAX_DEPTH = 10000.0  # sentinel depth for invalid samples


def sdf_losses(
    z_vals: torch.Tensor,      # (R, M) sample depths (MAX_DEPTH where invalid)
    sdf: torch.Tensor,         # (R, M) predicted sdf (1.0 where invalid)
    valid_mask: torch.Tensor,  # (R, M) bool
    ray_mask: torch.Tensor,    # (R,) bool
    gt_points: torch.Tensor,   # (R, 3) sensor-frame measured points
    points_cos: torch.Tensor,  # (R,)
    truncation: float,
    max_depth: float,
    fs_weight: float,
    sdf_weight: float,
    sdf_bias=0.0,
):
    """Weighted free-space + truncated-SDF loss: (loss, loss dict)."""
    gt_distance = norm3(gt_points) * points_cos
    z = z_vals * points_cos[:, None]
    d = gt_distance[:, None]
    valid = valid_mask & ray_mask[:, None]

    front_mask = (z < (d - truncation)) & valid
    back_mask = (z > (d + truncation)) & valid
    depth_ok = (gt_distance > 0.0) & (gt_distance < max_depth)
    sdf_mask = valid & ~front_mask & ~back_mask & depth_ok[:, None]

    num_fs = front_mask.sum()
    num_sdf = sdf_mask.sum()
    total = torch.clamp(num_fs + num_sdf, min=1).to(z.dtype)
    fs_count_w = 1.0 - num_fs.to(z.dtype) / total
    sdf_count_w = 1.0 - num_sdf.to(z.dtype) / total
    denom = torch.clamp(ray_mask.sum() * z.shape[1], min=1).to(z.dtype)

    fm = front_mask.to(z.dtype)
    fs_loss = (torch.sum(torch.square(sdf * fm - fm)) / denom) * fs_count_w
    sm = sdf_mask.to(z.dtype)
    sdf_se = torch.square((z + (sdf - sdf_bias) * truncation) * sm - d * sm)
    sdf_loss = (torch.sum(sdf_se) / denom) * sdf_count_w

    loss = fs_weight * fs_loss + sdf_weight * sdf_loss
    return loss, {"fs_loss": fs_loss, "sdf_loss": sdf_loss, "loss": loss}
