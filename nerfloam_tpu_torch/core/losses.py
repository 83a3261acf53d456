"""SDF training losses (port of nerfloam_tpu/core/losses.py).

Free-space loss pushes the sdf to +1 in front of the measured surface;
the truncated-SDF loss pushes z + sdf * trunc to the measured distance
inside the band; count-balancing weights come from the batch's own sample
counts; z and d are scaled by the ground-normal cosine. Under a dp process
group (rays split over ranks, ``parallel/sharding.py``) the counts are the
global ones, as JAX's psums make them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

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
    *,
    gt_norm: torch.Tensor,     # (R,) |gt_points|
    sdf_bias=0.0,
    group=None,
):
    """Weighted free-space + truncated-SDF loss: (loss, loss dict).
    ``gt_norm``: the measured points' lengths, as ``ieee.norm3`` gives
    them (the trackers and BA take them once, ``tracking.ray_prep``, and
    gather them with their rays).

    ``group``: a ``torch.distributed`` group whose ranks each hold a block
    of the rays (JAX's ``axis_name``, losses.py:44-62). The three counts
    (front samples, band samples, hit rays) are all-reduced, one collective,
    before the weights and the denominator; each rank's loss is then its
    own sums over the global counts: the sum of the ranks' losses is the
    global loss, and each rank's gradient its part of the global gradient
    (the caller all-reduces both). None: one device, nothing changes."""
    gt_distance = gt_norm * points_cos
    z = z_vals * points_cos[:, None]
    d = gt_distance[:, None]
    valid = valid_mask & ray_mask[:, None]

    front_mask = (z < (d - truncation)) & valid
    back_mask = (z > (d + truncation)) & valid
    depth_ok = (gt_distance > 0.0) & (gt_distance < max_depth)
    sdf_mask = valid & ~front_mask & ~back_mask & depth_ok[:, None]

    num_fs = front_mask.sum()
    num_sdf = sdf_mask.sum()
    num_rays = ray_mask.sum()
    if group is not None:
        counts = torch.stack([num_fs, num_sdf, num_rays])
        dist.all_reduce(counts, group=group)
        num_fs, num_sdf, num_rays = counts.unbind()
    total = torch.clamp(num_fs + num_sdf, min=1).to(z.dtype)
    fs_count_w = 1.0 - num_fs.to(z.dtype) / total
    sdf_count_w = 1.0 - num_sdf.to(z.dtype) / total
    denom = torch.clamp(num_rays * z.shape[1], min=1).to(z.dtype)

    fm = front_mask.to(z.dtype)
    fs_loss = (torch.sum(torch.square(sdf * fm - fm)) / denom) * fs_count_w
    sm = sdf_mask.to(z.dtype)
    sdf_se = torch.square((z + (sdf - sdf_bias) * truncation) * sm - d * sm)
    sdf_loss = (torch.sum(sdf_se) / denom) * sdf_count_w

    loss = fs_weight * fs_loss + sdf_weight * sdf_loss
    return loss, {"fs_loss": fs_loss, "sdf_loss": sdf_loss, "loss": loss}
