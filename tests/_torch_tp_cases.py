"""The tp cases of tests/test_torch_tp.py, run on each spawned rank.

This module imports torch, numpy and the port only: a spawned rank imports
it by name (``parallel.sharding.spawn`` pickles ``run_cases`` by
reference), and must not import JAX or the test module. The parent builds
every input (and JAX's results) and hands the ranks numpy arrays; each rank
returns numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from nerfloam_tpu_torch.map.voxel_map import MapConfig
from nerfloam_tpu_torch.models.decoder import decoder_leaves
from nerfloam_tpu_torch.ops.raycast import RaycastConfig
from nerfloam_tpu_torch.parallel import sharding
from nerfloam_tpu_torch.utils.bridge import (
    decoder_params_from_jax,
    map_state_from_numpy,
    to_numpy,
)


def _decoder_case(p, mesh):
    """tp_decoder_apply of this rank's blocks on every row, f32 and bf16."""
    dec = sharding.shard_decoder_params(decoder_params_from_jax(p["dec"], device="cpu"), mesh)
    x = torch.as_tensor(p["x"])
    return {dt: to_numpy(sharding.tp_decoder_apply(dec, x, mesh, getattr(torch, dt)))
            for dt in ("float32", "bfloat16")}


def _ba_case(p, mesh, n_steps):
    """``n_steps`` of make_sharded_ba_iteration on this rank's dp block of
    the rays: after each step the loss, pose, packed table and decoder
    leaves; after the first the Adam moments (mu = 0.1 g: the raw
    gradients)."""
    cfg = MapConfig(**p["map_cfg"])
    rc = RaycastConfig(**p["rc"])
    state = map_state_from_numpy(p["state"], device="cpu")
    dec = sharding.shard_decoder_params(decoder_params_from_jax(p["dec"], device="cpu"), mesh)
    pose = torch.as_tensor(p["pose6"])
    R = p["pts"].shape[0]
    n = R // mesh.dp
    rows = slice(mesh.dp_index * n, (mesh.dp_index + 1) * n)
    pts, cos, val = (torch.as_tensor(p[k][rows]) for k in ("pts", "cos", "val"))
    step, init_opt = sharding.make_sharded_ba_iteration(cfg, rc, 0.3, rc.max_depth, mesh=mesh)
    opt = init_opt(state, dec, pose)
    out = []
    for k in range(n_steps):
        packed, dec, pose, loss, opt = step(state, dec, pose, pts, cos, val, p["lrs"],
                                            torch.as_tensor(p["u"][mesh.dp][k]), opt)
        state = state._replace(packed=packed)
        rec = {"loss": float(loss), "pose": pose.numpy(), "packed": packed.numpy(),
               "dec": [to_numpy(t) for t in decoder_leaves(dec)]}
        if k == 0:
            rec["mu"] = [to_numpy(m).copy() for m in opt["mu"]]  # the moments change in place
        out.append(rec)
    return out


def run_cases(rank, world_size, device, inputs):
    """Every case on this rank, in one process group (gloo, the CPU)."""
    torch.manual_seed(0)
    mesh = sharding.make_mesh(world_size)
    out = {"mesh": [mesh.dp, mesh.tp, mesh.dp_index, mesh.tp_index],
           "decoder": _decoder_case(inputs["decoder"], mesh),
           "ba": _ba_case(inputs["ba"], mesh, inputs["n_steps"])}
    if rank == 0:  # the one-process layout beside the group's
        one = sharding.Mesh(1, 1, 0, 0)
        out["ba_one"] = _ba_case(inputs["ba"], one, inputs["n_steps"])
    return out
