"""Yaml-free configuration (port of nerfloam_tpu/utils/config.py:55-280).

``Config`` is built from a plain dict (a JSON file, or a dict produced by
the JAX package's ``load_config``), merged over the same defaults as the
JAX package so a config means the same thing on both sides.
"""

from __future__ import annotations

import copy
import json
import math
from typing import Any, Dict


def update_recursive(dict1: Dict, dict2: Dict) -> Dict:
    """dict2 wins; nested dicts merge."""
    for k, v in dict2.items():
        if isinstance(v, dict) and isinstance(dict1.get(k), dict):
            update_recursive(dict1[k], v)
        else:
            dict1[k] = copy.deepcopy(v)
    return dict1


class Config:
    """Attribute view over the merged config dict."""

    def __init__(self, d: Dict[str, Any]):
        self._d = d

    def __getattr__(self, k):
        d = object.__getattribute__(self, "_d")
        if k in d:
            return d[k]
        raise AttributeError(k)

    def __getitem__(self, k):
        return self._d[k]

    def get(self, k, default=None):
        return self._d.get(k, default)

    def as_dict(self) -> Dict:
        return copy.deepcopy(self._d)


# The JAX package's DEFAULTS (nerfloam_tpu/utils/config.py:84-246), knobs only.
DEFAULTS = {
    "criteria": {},
    "decoder_specs": {},
    "tracker_specs": {},
    "mapper_specs": {},
    "data_specs": {},
    "debug_args": {},
    "tpu_specs": {
        "points_pad": 131072,
        "kf_points_pad": 65536,
        "map_capacity": 1 << 19,
        "track_samples": 128,
        "map_samples": 64,
        "region_z_half": 20.0,
        "region_margin": 4.0,
        "bootstrap_steps": 20,
        "compute_dtype": "float32",
        "emb_dtype": "float32",
        "active_cap": 1 << 18,
        "touched_cap": 0,
        "reconcile_mode": "mean",
        "exact_embedding_grads": False,
        "track_resample_rays": False,
        "ba_ray_superset": 2,
        "dp": 1,
        "coarse_factor": 1.0,
        "sampler": "grid",
        "max_hits": 20,
        "bias_source": "window",
        "bias_classes": 1,
        "defer_sync": True,
        "recenter_margin": 0.0,
        "track_method": "gn",
        "track_gn_iterations": 16,
        "surface_anchor": 0,
        "band_samples": 0,
        "ba_pose_project": "none",
        "maturity_warmup": 0,
        "maturity_floor": 0.25,
        "support_dist": 0.0,
        "support_sym": False,
        "bias_correction": False,
        "replay_freq": 0,
        "s2s_weight": 0.0,
        "s2s_elev": 64,
        "s2s_az": 1024,
        "s2s_gate": 1.0,
        "s2s_huber": 0.2,
        "const_vel_full": True,
        "mesh_backend": "mt",
        "seed": 777,
    },
}


def finalize(d: Dict) -> Config:
    """Merge a config dict over DEFAULTS."""
    return Config(update_recursive(copy.deepcopy(DEFAULTS), d))


def load_json_config(path: str) -> Config:
    with open(path) as f:
        return finalize(json.load(f))


def derive_static_shapes(cfg: Config) -> Dict[str, Any]:
    """The static shapes the pipeline needs (JAX config.py:255-280)."""
    vs = cfg.mapper_specs["voxel_size"]
    max_depth = float(cfg.data_specs["max_depth"])
    key_distance = float(cfg.mapper_specs.get("key_distance", 12.0))
    keyframe_gap = float(cfg.mapper_specs.get("keyframe_gap", 8.0))
    window = int(cfg.mapper_specs["window_size"])
    margin = float(cfg.tpu_specs["region_margin"])
    half_xy = max(max_depth, window * keyframe_gap + key_distance * 1.8) + margin
    half_z = float(cfg.tpu_specs["region_z_half"])
    Dxy = 2 * math.ceil(half_xy / vs)
    Dz = 2 * math.ceil(half_z / vs)
    track_step = float(cfg.tracker_specs["step_size"]) * vs
    map_step = float(cfg.mapper_specs["step_size"]) * vs
    return {
        "grid_dim": (Dxy, Dxy, Dz),
        "track_step_world": track_step,
        "map_step_world": map_step,
        "track_n_slots": math.ceil(max_depth / track_step) + 1,
        "map_n_slots": math.ceil(max_depth / map_step) + 1,
        "max_depth": max_depth,
        "voxel_size": vs,
    }
