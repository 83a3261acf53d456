#!/usr/bin/env python3
"""Device and host time of K3 (GN normal equations) and K8 (active-grid
field) at the shapes the main paths give them, on one CUDA card, through
the function forms ``tracking.gn_system`` and ``render.active_field_fwd``
(which every tree of the port has since its second slice) and, where the
tree has them, the per-frame objects ``tracking.GnSystem`` and
``render.ActiveField``.

    python3 scripts/k3_k8_profile.py

Run it from the root of the tree to profile (it imports that tree's
package and its chip_smoke.py for the profiler helpers and the CUDA
function names); to compare two trees in one call, copy it into the
other tree's ``scripts/`` and run the two in turns.

Shapes, on the kernel phase's map of chip_smoke.py (the quality config's
first three frames inserted, random embeddings): the quality tracker's
2048 rays (K8's band columns 2048 x 8, with one origin per ray and with
the trackers' one origin expanded to every ray, row stride 0; K3 on a GN
iteration's real 2048 x (64 + 8) columns) and the bias probe (65,536 x 1
given points); the replica gate's tracker, 384 rays on the grid sampler
(its sample count; K8's grid columns and band columns, K3 on their
concatenation). For each
it prints device us per launch of each CUDA function and CUDA launches
per call (torch.profiler), and host us per call. Prints no result line.
"""

import os
import subprocess
import sys
from functools import partial

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nerfloam_tpu_torch import kernels  # noqa: E402
from nerfloam_tpu_torch.core import render  # noqa: E402
from nerfloam_tpu_torch.core import tracking as tr  # noqa: E402
from nerfloam_tpu_torch.core.frame import Frame, pose6_from_matrix_np  # noqa: E402
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch  # noqa: E402
from nerfloam_tpu_torch.data import get_dataset  # noqa: E402
from nerfloam_tpu_torch.map import voxel_map as vm  # noqa: E402
from nerfloam_tpu_torch.ops import raycast, se3  # noqa: E402
from nerfloam_tpu_torch.ops.sampling import sample_ray_indices  # noqa: E402

log = cs.log


def profile(label, name, fn):
    """chip_smoke's per-function device us and launches of one call."""
    per_fn, per_call, launches = cs.device_us(name, fn)
    log(f"[profile {label}] device us per launch: "
        + ", ".join(f"{k} {v:.2f}" for k, v in per_fn.items())
        + f"; {per_call:.2f} us per call; {launches:g} CUDA launches per call")


def host(label, pieces):
    log(f"[host {label}] us per call: "
        + ", ".join(f"{k} {cs.host_us(fn):.2f}" for k, fn in pieces.items()))


def build_map(slam, ds, dev, gen):
    cfg = slam.map_cfg
    frames = []
    for i in range(3):
        idx, pts, cos, _ = ds[i]
        frames.append(Frame.from_raw(idx, pts, cos, ds.get_init_pose(i), slam.points_pad))
    ms = vm.create(cfg, dev)
    ms = vm.recenter(ms, cfg, torch.as_tensor(frames[0].pose6[:3], device=dev))
    for f in frames:
        p, c, v = f.device_arrays(dev)
        ms = vm.insert_frame(ms, cfg, p, c, v, torch.as_tensor(f.pose6, device=dev),
                             slam.insert_cand_cap)
        if hasattr(vm, "undo_insert"):  # the in-place insert returns (state, record)
            ms = ms[0]
    emb = torch.randn(ms.embeddings.shape, generator=gen, device=dev) * 0.1
    return vm.refresh_active(ms._replace(embeddings=emb.to(ms.embeddings.dtype)), cfg), frames


def tracker_columns(slam, ms, frame, pose, n_rays, rc, gen):
    """One GN iteration's rays and columns at ``pose``: the sampler's (K1
    on the hit table, or K9b + K8 on the grid) and the band columns (K8),
    concatenated as the tracker does; K3's inputs."""
    dev, cfg, tp = slam.device, slam.map_cfg, slam.tp
    p, c, v = frame.device_arrays(dev)
    idx, rvalid = sample_ray_indices(v, n_rays, gen)
    pts, pcos = p[idx], c[idx]
    rp = tr.ray_prep(pts, pcos, tp.truncation, tp.max_depth)
    d = se3.rotate_dirs(pose, rp.dirs).contiguous()
    t_pos = se3.pose_translation(pose)
    o1 = t_pos.expand_as(d)
    tc = rp.t_cap
    u = raycast.uniform_jitter((n_rays, rc.n_samples), gen, dev)
    if rc.sampler == "hits":
        ht = raycast.build_hit_table(ms, cfg, rc, o1.contiguous(), d, tc)
        cols = render.hits_field_fwd(ht, u, o1.contiguous(), d, ms.packed, cfg.voxel_size)
        ray_mask = ht.ray_mask
    else:
        cdf, n_occ = raycast.march_occupancy(ms, cfg, rc, o1.contiguous(), d, tc)
        z, aid, valid, ray_mask = raycast.place_samples_cdf(ms, cfg, rc, cdf, n_occ,
                                                            o1.contiguous(), d, tc, u)
        z, ray_mask = z.clone(), ray_mask.clone()
        _, _, xyz, feats = render.active_field_fwd(ms, cfg, ms.packed, o1.contiguous(), d, z,
                                                   ray_mask)
        cols = (z, valid.clone(), aid.clone(), xyz, feats)
    ub = torch.rand((n_rays, tp.band_samples), generator=gen, device=dev)
    ez = render.extra_surface_z(torch.linalg.norm(pts, dim=-1), pcos, tp.truncation,
                                tp.surface_anchor, tp.band_samples, ub)
    eaid, evalid, exyz, efeats = render.active_field_fwd(ms, cfg, ms.packed, o1.contiguous(), d,
                                                         ez, rvalid)
    z, valid, aid, xyz, feats = (torch.cat(x, 1) for x in
                                 zip(cols, (ez, evalid, eaid, exyz, efeats)))
    sdf, g = tr.field_and_grad(slam.state.decoder_params, feats, xyz, aid, valid, ms.packed,
                               cfg.voxel_size, getattr(torch, tp.compute_dtype))
    d_meas = torch.linalg.norm(pts, dim=-1) * pcos
    depth_ok = (d_meas > 0.0) & (d_meas < tp.max_depth)
    bias_ray = torch.where(pcos < 0.999, 0.01, -0.005)
    k3 = (xyz, t_pos, z, sdf, g, valid & rvalid[:, None], pcos, d_meas, depth_ok, tp, bias_ray)
    return dict(o=o1.contiguous(), o1=o1, d=d, ez=ez, rvalid=rvalid, grid=cols[0] if
                rc.sampler == "grid" else None, ray_mask=ray_mask, k3=k3)


def main():
    if not torch.cuda.is_available():
        print("k3_k8_profile: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kernels.lib()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {smi}")
    q = NerfLoamSLAM_torch(cs.load_cfg(ROOT, "kitti_quality"), None, device=dev)
    gate = NerfLoamSLAM_torch(cs.load_cfg(ROOT, "replica_gate60", seed=0), None, device=dev)
    ds = get_dataset(q.cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    ms, frames = build_map(q, ds, dev, gen)
    cfg = q.map_cfg
    pose = torch.as_tensor(pose6_from_matrix_np(ds.get_init_pose(0)), device=dev)
    has_objects = hasattr(render, "ActiveField") and hasattr(tr, "GnSystem")
    log(f"[map] {int(ms.n_active)} active voxels (A={ms.packed.shape[0]}); the tree has "
        f"{'the per-frame objects' if has_objects else 'the function forms only'}")

    shapes = {"quality": tracker_columns(q, ms, frames[0], pose, q.tp.n_rays, q.rc_track, gen),
              # the gate's rays and samples on the grid sampler, over the same map
              "gate": tracker_columns(q, ms, frames[0], pose, gate.tp.n_rays,
                                      q.rc_track._replace(sampler="grid",
                                                          n_samples=gate.rc_track.n_samples),
                                      gen)}
    p, c, v = frames[0].device_arrays(dev)
    depth = torch.linalg.norm(p, dim=-1)
    probe = (None, None, depth.reshape(-1, 1), v & (depth < q.rc_map.max_depth),
             se3.transform_points(pose, p).reshape(-1, 1, 3))
    k8 = partial(render.active_field_fwd, ms, cfg, ms.packed)
    for label, s in shapes.items():
        forms = {f"K8 {label} band {tuple(s['ez'].shape)}, origin per ray": (s["o"], s["d"],
                                                                             s["ez"], s["rvalid"]),
                 f"K8 {label} band {tuple(s['ez'].shape)}, origin row stride 0": (
                     s["o1"], s["d"], s["ez"], s["rvalid"])}
        if s["grid"] is not None:
            forms[f"K8 {label} grid columns {tuple(s['grid'].shape)}, origin row stride 0"] = (
                s["o1"], s["d"], s["grid"], s["ray_mask"])
        if label == "quality":
            forms["K8 probe (65536, 1)"] = probe
        for f_label, args in forms.items():
            profile(f_label, "active_field_fwd", partial(k8, *args))
            pieces = {"active_field_fwd": partial(k8, *args)}
            if has_objects:
                field = render.ActiveField(ms, cfg)
                pieces["ActiveField made"] = partial(render.ActiveField, ms, cfg)
                pieces["ActiveField call"] = partial(field, ms.packed, *args)
            host(f_label, pieces)
        a3 = s["k3"]
        k3_label = f"K3 {label} {tuple(a3[2].shape)}"
        profile(k3_label, "gn_system", partial(tr.gn_system, *a3))
        pieces = {"gn_system": partial(tr.gn_system, *a3)}
        if has_objects:
            system = tr.GnSystem(*a3[6:9], a3[10], a3[9], a3[2].shape[1])
            pieces["GnSystem made"] = partial(tr.GnSystem, *a3[6:9], a3[10], a3[9],
                                              a3[2].shape[1])
            pieces["GnSystem call"] = partial(system, *a3[:6])
        host(k3_label, pieces)
    return 0


if __name__ == "__main__":
    sys.exit(main())
