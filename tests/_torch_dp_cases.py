"""The dp cases of tests/test_torch_sharding.py, run on each spawned rank.

This module imports torch, numpy and the port only: a spawned rank imports
it by name (``parallel.sharding.spawn`` pickles ``run_cases`` by
reference), and must not import JAX or the test module. The parent builds
every input (and JAX's results) and hands the ranks numpy arrays; each rank
returns numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from nerfloam_tpu_torch.core import ba as tba
from nerfloam_tpu_torch.core import losses as tlosses
from nerfloam_tpu_torch.core import scan2scan as ts2s
from nerfloam_tpu_torch.core import tracking as ttr
from nerfloam_tpu_torch.map.voxel_map import MapConfig
from nerfloam_tpu_torch.ops import ieee
from nerfloam_tpu_torch.ops import sampling as tsampling
from nerfloam_tpu_torch.ops.raycast import RaycastConfig
from nerfloam_tpu_torch.parallel import sharding
from nerfloam_tpu_torch.utils.bridge import (
    decoder_params_from_jax,
    map_state_from_numpy,
    prev_scan_from_numpy,
    to_numpy,
)


class _Fed:
    """The port's draws replaced by given arrays while it is in use: every
    Gumbel draw returns ``gumbel``, every jitter ``uniform`` and every
    ``torch.randint`` ``randint`` (reshaped to the shape asked for), as the
    JAX side's traced loop body draws one constant each."""

    def __init__(self, gumbel=None, uniform=None, randint=None):
        self.arrays = {"gumbel": gumbel, "uniform": uniform, "randint": randint}

    def _take(self, kind, shape, dtype):
        a = self.arrays[kind]
        assert a is not None and a.size == int(np.prod(shape)), (kind, shape)
        return torch.as_tensor(a.reshape(tuple(shape)), dtype=dtype)

    def __enter__(self):
        self.saved = (tsampling.gumbel, ttr.uniform_jitter, tba.uniform_jitter, torch.randint)
        tsampling.gumbel = lambda shape, generator, device: self._take(
            "gumbel", shape, torch.float32)
        jitter = lambda shape, generator, device: self._take("uniform", shape, torch.float32)
        ttr.uniform_jitter = tba.uniform_jitter = jitter
        real_randint = torch.randint

        def randint(low, high, size, generator=None, device=None):
            if self.arrays["randint"] is None:
                return real_randint(low, high, size, generator=generator, device=device)
            return self._take("randint", size, torch.int64)

        torch.randint = randint
        return self

    def __exit__(self, *exc):
        tsampling.gumbel, ttr.uniform_jitter, tba.uniform_jitter, torch.randint = self.saved


def _grad_case(p, group):
    """The gradient of the sharded sdf loss (each rank its block of the
    rays, the counts all-reduced) with respect to the whole sdf, summed over
    the ranks; and the single-process gradient."""
    t = {k: torch.as_tensor(v) for k, v in p.items()}
    rows = sharding.dp_cols(group, t["z"].shape[0])

    def loss_of(sdf, g, rows):
        loss, _ = tlosses.sdf_losses(t["z"][rows], sdf[rows], t["valid"][rows],
                                     t["raymask"][rows], t["gt"][rows], t["cos"][rows], 0.3, 10.0,
                                     1.0, 100.0, gt_norm=ieee.norm3(t["gt"][rows]), group=g)
        return loss

    sdf = t["sdf"].clone().requires_grad_(True)
    (g_dp,) = torch.autograd.grad(loss_of(sdf, group, rows), sdf)
    dist.all_reduce(g_dp, group=group)
    sdf1 = t["sdf"].clone().requires_grad_(True)
    (g_one,) = torch.autograd.grad(loss_of(sdf1, None, slice(None)), sdf1)
    return {"dp": g_dp.numpy(), "one": g_one.numpy()}


def _tiny(problem):
    """The tiny problem's map, config, raycast config and decoder on the CPU."""
    cfg = MapConfig(**problem["map_cfg"])
    state = map_state_from_numpy(problem["state"], device="cpu")
    rc = RaycastConfig(**problem["rc"])
    return cfg, state, rc, decoder_params_from_jax(problem["dec"], device="cpu")


def _gn_case(problem, sampler, draws, group, s2s=None):
    """The GN tracker; ``s2s``: {"sp": Scan2ScanParams' fields, "prev": a
    numpy PrevScan}, the scan-to-scan term on."""
    cfg, state, rc, dec = _tiny(problem)
    tp = ttr.TrackParams(n_rays=256, num_iterations=4, truncation=0.3, max_depth=rc.max_depth,
                         fs_weight=1.0, sdf_weight=1000.0,
                         s2s=None if s2s is None else ts2s.Scan2ScanParams(**s2s["sp"]))
    prev = None if s2s is None else prev_scan_from_numpy(s2s["prev"], device="cpu")
    t = lambda a: torch.as_tensor(a)
    with _Fed(gumbel=draws["gumbel"], uniform=draws["uniform"]):
        res = ttr.track_frame_gn(state, cfg, rc._replace(sampler=sampler), tp, dec,
                                 t(problem["init"]), t(problem["pts"]), t(problem["cos"]),
                                 t(problem["val"]), torch.Generator(), prev_scan=prev,
                                 group=group)
    return {"pose": res.pose.numpy(), "hits": int(res.hit_count), "loss": float(res.loss)}


def _ba_case(problem, superset, draws, group, exact=False):
    cfg, state, rc, dec = _tiny(problem)
    bp = tba.BAParams(n_frames=1, n_rays=256, num_iterations=4, truncation=0.3,
                      max_depth=rc.max_depth, fs_weight=1.0, sdf_weight=1000.0,
                      ray_superset=superset, exact_embedding_grads=exact)
    t = lambda a: torch.as_tensor(a)
    with _Fed(**draws):
        res = tba.ba_step(state, cfg, rc, bp, dec, t(problem["pose6"])[None],
                          t(problem["pts"])[None], t(problem["cos"])[None],
                          t(problem["val"])[None], torch.ones(1, dtype=torch.bool),
                          torch.ones(1, dtype=torch.bool), True, [0.02, 0.005, 0.001],
                          torch.Generator(), group=group)
    return {"loss": float(res.loss), "poses": res.poses.numpy(),
            "embeddings": to_numpy(res.embeddings), "packed": to_numpy(res.packed),
            "touched": int(res.touched_count)}


def _pipeline_case(rank, device, cfg_dict, log_dir):
    """run_dp's rank body, every rank given a logger under log_dir."""
    from nerfloam_tpu_torch.data import get_dataset

    out = sharding._run_pipeline(rank, dist.get_world_size(), device, cfg_dict, get_dataset,
                                 None, log_dir)
    return {"poses": out["poses"], "packed_sha256": out["packed_sha256"]}


def _raises_case(cfg_dict):
    """The pipeline with a ray count dp does not divide: its error."""
    from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
    from nerfloam_tpu_torch.utils.config import Config

    try:
        NerfLoamSLAM_torch(Config(cfg_dict), None, "cpu")
    except ValueError as e:
        return str(e)
    return None


def run_cases(rank, world_size, device, inputs):
    """Every case on this rank, in one process group (gloo, the CPU)."""
    group = dist.group.WORLD
    torch.manual_seed(0)
    out = {"grad": _grad_case(inputs["grad"], group)}
    for sampler in ("grid", "hits"):
        out[f"gn_{sampler}"] = _gn_case(inputs["tiny"], sampler, inputs[f"gn_{sampler}"], group)
    out["gn_s2s"] = _gn_case(inputs["tiny"], "grid", inputs["gn_s2s"], group, inputs["s2s"])
    for superset in (2, 0):
        out[f"ba_{superset}"] = _ba_case(inputs["tiny"], superset, inputs[f"ba_{superset}"],
                                         group)
    out["ba_exact"] = _ba_case(inputs["tiny"], 0, inputs["ba_exact"], group, exact=True)
    out["raises"] = _raises_case(inputs["raises_cfg"])
    out["pipeline"] = _pipeline_case(rank, device, inputs["pipeline_cfg"], inputs["log_dir"])
    out["pipeline_adam"] = _pipeline_case(rank, device, inputs["adam_cfg"], None)
    return out
