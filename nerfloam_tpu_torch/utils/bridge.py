"""Numpy bridges from the JAX package's state to the port's.

Parity tests build inputs with the JAX package, convert them to numpy
(``jax.device_get``) and hand them to these functions; nothing here
imports jax. Field names match the JAX NamedTuples, so either a NamedTuple
of numpy arrays or a dict works.
"""

from __future__ import annotations

import numpy as np
import torch

from nerfloam_tpu_torch.core.scan2scan import PrevScan
from nerfloam_tpu_torch.map.voxel_map import MapConfig, MapState
from nerfloam_tpu_torch.models.decoder import decoder_params_from_jax
from nerfloam_tpu_torch.ops import se3
from nerfloam_tpu_torch.ops.raycast import HitTable

__all__ = ["decoder_params_from_jax", "map_config_from_jax", "map_state_from_numpy",
           "hit_table_from_numpy", "prev_scan_from_numpy", "load_jax_checkpoint", "to_numpy"]


def _fields(obj) -> dict:
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from jax.device_get
        return torch.as_tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.as_tensor(np.array(a), device=device)  # copy: jax arrays are read-only


def map_config_from_jax(cfg) -> MapConfig:
    """The port's MapConfig from the JAX one (same fields, support voxels
    included), so both sides insert the same points."""
    return MapConfig(**{k: getattr(cfg, k) for k in MapConfig._fields})


def map_state_from_numpy(state, device="cuda") -> MapState:
    """A numpy MapState (nerfloam_tpu/map/voxel_map.py:65-97) -> the port's."""
    f = _fields(state)
    C = np.asarray(f["lat_coords"]).shape[0]
    if f.get("num_cand") is None:
        f["num_cand"] = np.zeros((), np.int32)
    if f.get("upd_count") is None:
        f["upd_count"] = np.zeros((C,), np.int32)
    return MapState(**{k: _tensor(f[k], device) for k in MapState._fields})


def hit_table_from_numpy(ht, device="cuda") -> HitTable:
    """A numpy HitTable (nerfloam_tpu/ops/raycast.py:133-156) -> the port's."""
    f = _fields(ht)
    return HitTable(**{k: _tensor(f[k], device) for k in HitTable._fields})


def prev_scan_from_numpy(prev, device="cuda") -> PrevScan:
    """A numpy PrevScan (nerfloam_tpu/core/scan2scan.py:58-67) -> the port's,
    whose previous-pose rotation and translation are built from pose6 as
    build_prev_scan builds them."""
    f = _fields(prev)
    out = {k: _tensor(f[k], device) for k in PrevScan._fields if k not in ("R", "t")}
    return PrevScan(**out, R=se3.pose_rotation(out["pose6"]), t=se3.pose_translation(out["pose6"]))


def load_jax_checkpoint(path: str, slam) -> None:
    """Carry a run of the JAX package over: load a checkpoint directory it
    wrote (``nerfloam_tpu.utils.checkpoint.save_checkpoint``) into a
    ``NerfLoamSLAM_torch`` built from the same config. The two packages
    share the npz keys and the manifest; ``jax_key`` has no meaning here, so
    the generator is seeded from the config, and the deferred-sync pose
    recurrence is dropped (the port runs the synchronous schedule)."""
    from nerfloam_tpu_torch.utils.checkpoint import load_checkpoint

    load_checkpoint(path, slam)


def to_numpy(x):
    """Tensors (or NamedTuples / dicts / lists of them) -> numpy, bf16 -> f32."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if hasattr(x, "_asdict"):
        return type(x)(*[to_numpy(v) for v in x])
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    return x
