#!/usr/bin/env python3
"""Device and host time of K9a (occupancy march), K10a (mesh lattice) and
K10b (marching tetrahedra) at the shapes the main paths give them, on
one CUDA card,
through the functions every tree of the port has since its fourth slice
(``raycast.march_occupancy``, ``raycast.CdfPlacer``,
``mesher.mesh_lattice`` and ``marching.marching_tets_lattice`` followed
by the ``tris[valid]`` that
compacted its output), with every device operation of a call listed by
name: the port's kernels and the torch operations around them (an
origin's copy, the boolean index's nonzero and gather), each with its
launches and device us per call. Where the tree has them, it also
profiles the forms that replaced those: ``CdfPlacer.march`` (the march
launched as part of making its placer) and
``marching.marching_tets_compact`` (the valid triangles compacted on the
card, then ``tris[:T]``).

    python3 scripts/k9a_k10b_profile.py

Run it from the root of the tree to profile (it imports that tree's
package, its chip_smoke.py for the profiler helpers and
scripts/k7_k11a_profile.py for the map and the per-operation split); to
compare two trees in one call, copy it into the other tree's
``scripts/`` and run the two in turns.

Shapes: the map chip_smoke.py's kernel phase builds (the quality
config's first three frames, random embeddings) and rays of its frame 0.
K9a at the Adam tracker's 2048 rays x 100 slots (one origin per ray, and
the trackers' one origin expanded to every ray), a tracker frame's march
+ placer made at adam25's shape and at the replica gate tracker's, and
BA's superset march + placer at the gate's 768 rows. K10a over every
surface voxel of the map at res 2 (the shipped mesh_res) and res 4, with
the config's bf16 and with f32 embeddings, beside the host us of the
conversions its first wrapper made. K10b over every surface voxel at res
2, on the decoder's sdf of K10a's lattice. Prints no result line.
"""

import os
import subprocess
import sys
from functools import partial

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from k7_k11a_profile import build_map, host, op_split  # noqa: E402
from nerfloam_tpu_torch import kernels  # noqa: E402
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch  # noqa: E402
from nerfloam_tpu_torch.core.tracking import ray_prep  # noqa: E402
from nerfloam_tpu_torch.data import get_dataset  # noqa: E402
from nerfloam_tpu_torch.map import mesher  # noqa: E402
from nerfloam_tpu_torch.map import voxel_map as vm  # noqa: E402
from nerfloam_tpu_torch.ops import marching, raycast, se3  # noqa: E402
from nerfloam_tpu_torch.ops.sampling import sample_ray_indices  # noqa: E402

log = cs.log
MARCH = hasattr(raycast.CdfPlacer, "march")
COMPACT = hasattr(marching, "marching_tets_compact")


def rays(frame, n, max_depth, gen, dev):
    """n rays of a frame at its pose: (one origin per ray, the origin
    expanded to every ray, directions, t_cap), as the kernel phase draws
    them."""
    p, c, v = frame.device_arrays(dev)
    pose = torch.as_tensor(frame.pose6, device=dev)
    idx, _ = sample_ray_indices(v, n, gen)
    rp = ray_prep(p[idx], c[idx], 0.3, max_depth)
    d = se3.rotate_dirs(pose, rp.dirs).contiguous()
    o1 = se3.pose_translation(pose).expand_as(d)
    return o1.contiguous(), o1, d, rp.t_cap


def k9a(ms, cfg, shapes):
    """shapes: {label: (rc, M, n_rays of a placer or None, origin form,
    (o, o1, d, tc))}."""
    for label, (rc, M, n_rays, form, (o, o1, d, tc)) in shapes.items():
        ro = o1 if form == "origin row stride 0" else o
        C, (_, S) = d.shape[0], raycast._coarse_shape(rc)
        log(f"[K9a] {label}: {C} rays x {S} slots, {M} samples, {form}")
        march = partial(raycast.march_occupancy, ms, cfg, rc, ro, d, tc)
        op_split(f"K9a march_occupancy {label}, {form}", march)

        def made():  # the parent's form: the march, then the placer over its cdf
            return raycast.CdfPlacer(ms, cfg, rc, *march(), tc, M, n_rays)

        op_split(f"K9a march_occupancy + CdfPlacer {label}", made)
        pieces = {"march_occupancy": march, "march_occupancy + CdfPlacer": made}
        if MARCH:
            marched = partial(raycast.CdfPlacer.march, ms, cfg, rc, ro, d, tc, M, n_rays)
            op_split(f"K9a CdfPlacer.march {label}", marched)
            pieces["CdfPlacer.march"] = marched
        host(f"K9a {label}", pieces)


def k10a(slam, ms):
    """K10a over the map's surface voxels: every device operation of a
    call at res 2 and 4, bf16 and f32, and the wrapper's host us at res 2
    beside the conversions the first wrapper made (a no-op here: the ids
    are int32, the tables contiguous)."""
    cfg, ids = slam.map_cfg, vm.surface_voxel_ids(ms)
    log(f"[K10a] {ids.numel()} surface voxels, feat_dim {cfg.feat_dim}")
    for dt in (ms.embeddings.dtype, torch.float32):
        st = ms._replace(embeddings=ms.embeddings.to(dt))
        for res in (2, 4):
            op_split(f"K10a mesh_lattice res {res} {dt}", partial(mesher.mesh_lattice, st, cfg,
                                                                   ids, res))
    host("K10a res 2", {
        "mesh_lattice": partial(mesher.mesh_lattice, ms, cfg, ids, 2),
        "the first wrapper's conversions": lambda: (ids.to(torch.int32).contiguous(), [
            t.contiguous() for t in (ms.corner_idx, ms.lat_coords, ms.embeddings)])})


def k10b(slam, ms, res=2):
    dev, cfg = slam.device, slam.map_cfg
    ids = vm.surface_voxel_ids(ms)
    cct = mesher._lattice_tables(res, dev)[2]
    feats, pos = mesher.mesh_lattice(ms, cfg, ids, res)
    sdf = mesher.decoder_apply(slam.state.decoder_params, feats,
                               getattr(torch, slam.compute_dtype))[..., 0].contiguous()
    padded = partial(marching.marching_tets_lattice, sdf, pos, cct, ids)
    tris, valid = padded()
    T = int(valid.sum())
    log(f"[K10b] res {res}: {ids.numel()} surface voxels, {ids.numel() * cct.shape[0]} cells, "
        f"T = {T} triangles")

    def padded_index():
        t, v = padded()
        return t[v]

    op_split("K10b marching_tets_lattice", padded)
    op_split("K10b marching_tets_lattice + tris[valid]", padded_index)
    pieces = {"marching_tets_lattice": padded,
              "marching_tets_lattice + tris[valid] to the host":
                  lambda: padded_index().cpu()}
    if COMPACT:
        # through one kept scratch, as the pipeline's meshes take it
        compact = partial(marching.marching_tets_compact, sdf, pos, cct, ids,
                          scratch=marching.TetScratch())
        op_split("K10b marching_tets_compact", compact)

        def compact_host():
            t, n = compact()
            return t[:int(n)].cpu()

        pieces["marching_tets_compact"] = compact
        pieces["marching_tets_compact + tris[:T] to the host"] = compact_host
    host("K10b", pieces)


def main():
    if not torch.cuda.is_available():
        print("k9a_k10b_profile: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kernels.lib()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {smi}; K9a CdfPlacer.march in this tree: {MARCH}, K10b compact: {COMPACT}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    q = NerfLoamSLAM_torch(cs.load_cfg(ROOT, "kitti_quality"), None, device=dev)
    ds = get_dataset(q.cfg)
    ms, frames = build_map(q, ds, dev, gen)
    cfg = q.map_cfg
    adam = NerfLoamSLAM_torch(cs.load_cfg(ROOT, "kitti_adam25"), None, device=dev)
    gate = NerfLoamSLAM_torch(cs.load_cfg(ROOT, "replica_gate60", seed=0), None, device=dev)
    rc_a = adam.rc_track._replace(sampler="grid")
    rc_gt, rc_gb = gate.rc_track._replace(sampler="grid"), gate.rc_map
    f0 = frames[0]
    ra = rays(f0, adam.tp.n_rays, rc_a.max_depth, gen, dev)
    rg = rays(f0, gate.tp.n_rays, rc_gt.max_depth, gen, dev)
    nb = gate.bp_current.n_rays
    rb = rays(f0, nb * gate.bp_current.ray_superset, rc_gb.max_depth, gen, dev)
    k9a(ms, cfg, {
        "adam25": (rc_a, rc_a.n_samples, None, "origin per ray", ra),
        "adam25 tracker": (rc_a, rc_a.n_samples, None, "origin row stride 0", ra),
        "gate60 tracker": (rc_gt, rc_gt.n_samples, None, "origin row stride 0", rg),
        "gate60 BA superset": (rc_gb, rc_gb.n_samples, nb, "origin per ray", rb),
    })
    k10a(q, ms)
    k10b(q, ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
