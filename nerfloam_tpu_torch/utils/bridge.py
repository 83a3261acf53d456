"""Numpy bridges from the JAX package's state to the port's.

Parity tests build inputs with the JAX package, convert them to numpy
(``jax.device_get``) and hand them to these functions; nothing here
imports jax. Field names match the JAX NamedTuples, so either a NamedTuple
of numpy arrays or a dict works.
"""

from __future__ import annotations

import numpy as np
import torch

from nerfloam_tpu_torch.map.voxel_map import MapState
from nerfloam_tpu_torch.models.decoder import decoder_params_from_jax
from nerfloam_tpu_torch.ops.raycast import HitTable

__all__ = ["decoder_params_from_jax", "map_state_from_numpy", "hit_table_from_numpy",
           "to_numpy"]


def _fields(obj) -> dict:
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from jax.device_get
        return torch.as_tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.as_tensor(np.array(a), device=device)  # copy: jax arrays are read-only


def map_state_from_numpy(state, device="cpu") -> MapState:
    """A numpy MapState (nerfloam_tpu/map/voxel_map.py:65-97) -> the port's."""
    f = _fields(state)
    C = np.asarray(f["lat_coords"]).shape[0]
    if f.get("num_cand") is None:
        f["num_cand"] = np.zeros((), np.int32)
    if f.get("upd_count") is None:
        f["upd_count"] = np.zeros((C,), np.int32)
    return MapState(**{k: _tensor(f[k], device) for k in MapState._fields})


def hit_table_from_numpy(ht, device="cpu") -> HitTable:
    """A numpy HitTable (nerfloam_tpu/ops/raycast.py:133-156) -> the port's."""
    f = _fields(ht)
    return HitTable(**{k: _tensor(f[k], device) for k in HitTable._fields})


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
