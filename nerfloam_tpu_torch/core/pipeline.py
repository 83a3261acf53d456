"""Single-process SLAM orchestration (port of nerfloam_tpu/core/pipeline.py,
synchronous schedule, single device).

frame 0: insert -> active refresh -> keyframe -> ``bootstrap_steps`` BA steps.
frame k: track (GN or Adam, ``track_method``) -> lazy recenter + active
refresh -> BA on the tracked frame -> voxel insert, then ONE host fetch of
the frame's results (poses, hit count, row counts, the BA's surface-bias
probe) and the host bookkeeping: the bias EMA and ``_post_frame``'s
keyframe-gap insertion, trajectory record and periodic mesh / checkpoint /
debug dumps.
finalize: the no-replay mesh, the ``final_iter`` random replay, the final
poses and mesh, all written through the run logger when there is one.

With ``tpu_specs.s2s_weight > 0`` the GN tracker adds the scan-to-scan
point-to-plane term (core/scan2scan.py): the previous frame's points, valid
mask and tracked pose are rasterized once per frame, before the tracker.

The quality stack the shipped configs turn on (``configs/kitti/kitti.yaml``)
is ported: support voxels on both sides of every surface point
(``support_dist``, ``support_sym``), band and anchor columns in the
tracker and BA (``band_samples``, ``surface_anchor``), and the bias
transfer (``bias_correction``): BA measures the final field's mean value
at the frame's points, the host keeps an EMA of it, and the next tracked
frame targets sdf = that offset on the band. Both samplers are ported:
``tpu_specs.sampler`` picks the hit table (hits) or the occupancy march
(grid) for the GN tracker and BA; the Adam tracker always marches.

Every budget overflow (capacity, active set, touched voxels, insert
candidates) is handled as in JAX: rewind the frame to its pre-frame state,
grow the budget and replay the frame with the same random stream
(the generator state is saved with the map), so growth never loses data.

Knobs the port does not implement yet raise ``NotImplementedError`` at
construction, naming their ROADMAP queue-1 item; none is ignored.
"""

from __future__ import annotations

import os
import random as pyrandom
from dataclasses import dataclass, field
from functools import partial

import numpy as np
import torch

from nerfloam_tpu_torch.core import ba as ba_mod
from nerfloam_tpu_torch.core import tracking as tr_mod
from nerfloam_tpu_torch.core.frame import Frame, pose6_from_matrix_np
from nerfloam_tpu_torch.core.scan2scan import Scan2ScanParams, build_prev_scan
from nerfloam_tpu_torch.map import mesher
from nerfloam_tpu_torch.map import voxel_map as vm
from nerfloam_tpu_torch.models.decoder import init_decoder
from nerfloam_tpu_torch.ops.marching import TetScratch
from nerfloam_tpu_torch.ops.raycast import RaycastConfig
from nerfloam_tpu_torch.utils.config import Config, derive_static_shapes, quality_knobs
from nerfloam_tpu_torch.utils.profiler import Profiler

# (knob, value that is implemented, ROADMAP queue-1 item that ports the rest)
_UNPORTED = [
    ("tpu_specs.defer_sync", lambda v: not v, "14 (defer_sync)"),
    ("tpu_specs.dp", lambda v: int(v) == 1, "16 (parallel/)"),
    ("tpu_specs.bias_source", lambda v: v == "window", "15 (knobs: keyframe bias probe)"),
    ("tpu_specs.bias_classes", lambda v: int(v) == 1, "15 (dropped: per-class bias)"),
    ("tpu_specs.exact_embedding_grads", lambda v: not v, "15 (knobs)"),
    ("tpu_specs.track_resample_rays", lambda v: not v, "15 (knobs)"),
    ("tpu_specs.ba_ray_superset", lambda v: int(v) > 0, "15 (knobs)"),
    ("tpu_specs.reconcile_mode", lambda v: v == "mean", "15 (knobs)"),
    ("tpu_specs.maturity_warmup", lambda v: int(v) == 0, "15 (knobs)"),
    ("tpu_specs.replay_freq", lambda v: int(v) == 0, "15 (knobs)"),
    ("tpu_specs.ba_pose_project", lambda v: v == "none", "15 (knobs)"),
    ("mapper_specs.remove_back", lambda v: not v, "15 (knobs)"),
]


def check_ported(cfg: Config):
    for key, ok, item in _UNPORTED:
        group, name = key.split(".")
        if name in cfg[group] and not ok(cfg[group][name]):
            raise NotImplementedError(
                f"{key}={cfg[group][name]!r} is not ported yet (ROADMAP queue 1, item {item})")


@dataclass
class SlamState:
    map_state: vm.MapState
    decoder_params: dict
    keyframes: list = field(default_factory=list)
    current_keyframe: Frame | None = None
    frame_poses: list = field(default_factory=list)    # (kf_idx, rel 4x4)
    final_poses: list = field(default_factory=list)
    tracking_trajectory: list = field(default_factory=list)
    last_frame: Frame | None = None
    rel_pose: np.ndarray | None = None
    first_frame_id: int = 0
    frames_processed: int = 0
    frame_telemetry: list = field(default_factory=list)  # (index, hit_ratio, loss,
    #   pooled surface bias) per tracked frame


class NerfLoamSLAM_torch:
    def __init__(self, cfg: Config, dataset, device, logger=None):
        check_ported(cfg)
        self.cfg = cfg
        self.dataset = dataset
        self.logger = logger  # utils.logger.RunLogger | None: meshes, poses, checkpoints
        self.device = torch.device(device)
        self.prof = Profiler(self.device)
        shapes = derive_static_shapes(cfg)
        q = quality_knobs(cfg, shapes["voxel_size"])
        tpu = cfg.tpu_specs
        self.points_pad = int(tpu["points_pad"])
        self.kf_points_pad = int(tpu["kf_points_pad"])
        self.insert_cand_cap = int(tpu.get("insert_cand_cap", 0)) or self.points_pad
        self.compute_dtype = tpu["compute_dtype"]
        self.map_cfg = vm.MapConfig(
            capacity=int(tpu["map_capacity"]),
            grid_dim=shapes["grid_dim"],
            voxel_size=shapes["voxel_size"],
            feat_dim=int(cfg.decoder_specs["in_dim"]),
            emb_dtype=tpu["emb_dtype"],
            active_cap=min(int(tpu.get("active_cap", 1 << 18)), int(tpu["map_capacity"])),
            support_dist=q["support_dist"],
            support_sym=q["support_sym"],
        )
        coarse = float(tpu.get("coarse_factor", 1.0)) * shapes["voxel_size"]
        max_hits = int(tpu.get("max_hits", 20))
        sampler = str(tpu.get("sampler", "grid"))
        if sampler not in ("grid", "hits"):
            raise ValueError(f"tpu_specs.sampler must be 'grid' or 'hits', got {sampler!r}")
        rc = dict(voxel_size=shapes["voxel_size"], max_depth=shapes["max_depth"],
                  coarse_step=coarse, sampler=sampler, max_hits=max_hits)
        self.rc_track = RaycastConfig(step_world=shapes["track_step_world"],
                                      n_slots=shapes["track_n_slots"],
                                      n_samples=int(tpu["track_samples"]), **rc)
        self.rc_map = RaycastConfig(step_world=shapes["map_step_world"],
                                    n_slots=shapes["map_n_slots"],
                                    n_samples=int(tpu["map_samples"]), **rc)
        tspec, mspec, crit = cfg.tracker_specs, cfg.mapper_specs, cfg.criteria
        base_tp = dict(n_rays=int(tspec["N_rays"]), truncation=float(crit["sdf_truncation"]),
                       max_depth=shapes["max_depth"], fs_weight=float(crit["fs_weight"]),
                       sdf_weight=float(crit["sdf_weight"]), compute_dtype=self.compute_dtype,
                       surface_anchor=q["surface_anchor"], band_samples=q["band_samples"])
        self.track_method = str(tpu.get("track_method", "gn"))
        self.s2s_weight = float(tpu.get("s2s_weight", 0.0))
        if self.s2s_weight > 0 and self.track_method == "gn":
            base_tp["s2s"] = Scan2ScanParams(
                weight=self.s2s_weight, n_elev=int(tpu.get("s2s_elev", 64)),
                n_az=int(tpu.get("s2s_az", 1024)), gate_dist=float(tpu.get("s2s_gate", 1.0)),
                huber=float(tpu.get("s2s_huber", 0.2)),
                min_depth=float(cfg.data_specs.get("min_depth", 0.5)),
                max_depth=shapes["max_depth"])
        if self.track_method == "gn":
            n_iter = int(tpu.get("track_gn_iterations", 8))
            self.tp = tr_mod.TrackParams(num_iterations=n_iter, **base_tp)
            self.tp_first = tr_mod.TrackParams(num_iterations=n_iter * 2, **base_tp)
        elif self.track_method == "adam":
            n_iter = int(tspec["num_iterations"])
            self.tp = tr_mod.TrackParams(num_iterations=n_iter, **base_tp)
            self.tp_first = tr_mod.TrackParams(num_iterations=n_iter * 5, **base_tp)
        else:
            raise ValueError(f"tpu_specs.track_method must be 'adam' or 'gn', "
                             f"got {self.track_method!r}")
        # Adam learning rate: x2 for the first two frames, /3 after (JAX
        # pipeline.py:227, 253-254, 1244-1248)
        self.track_lr = float(tspec["learning_rate"])
        self.const_vel_full = bool(tpu.get("const_vel_full", False))

        acap_v = vm.acap(self.map_cfg)
        tc = int(tpu.get("touched_cap", 0))
        tc_cur, tc_rand = (min(tc, acap_v),) * 2 if tc > 0 else (min(acap_v, 8192),
                                                                  min(acap_v, 32768))
        base_bp = dict(truncation=float(crit["sdf_truncation"]), max_depth=shapes["max_depth"],
                       fs_weight=float(crit["fs_weight"]), sdf_weight=float(crit["sdf_weight"]),
                       compute_dtype=self.compute_dtype,
                       ray_superset=int(tpu.get("ba_ray_superset", 2)),
                       surface_anchor=q["surface_anchor"], band_samples=q["band_samples"],
                       measure_bias=q["bias_correction"])
        self.bp_current = ba_mod.BAParams(n_frames=1, n_rays=int(mspec["N_rays_each"]),
                                          num_iterations=int(mspec["num_iterations"]),
                                          touched_cap=tc_cur, **base_bp)
        self.window_size = int(mspec["window_size"])
        self.bp_random = ba_mod.BAParams(n_frames=self.window_size,
                                         n_rays=int(mspec["N_rays_each"]) * 2,
                                         num_iterations=int(mspec["num_iterations"]),
                                         touched_cap=tc_rand, **base_bp)
        self.ba_lrs = [float(mspec["learning_rate_emb"]), float(mspec["learning_rate_decorder"]),
                       float(mspec["learning_rate_pose"])]
        self.freeze_frame = int(mspec["freeze_frame"])
        self.keyframe_gap = float(mspec["keyframe_gap"])
        self.key_distance = float(mspec["key_distance"])
        self.final_iter = bool(mspec.get("final_iter", False))
        self.mesh_res = int(mspec.get("mesh_res", 2))
        self.mesh_freq = int(cfg.debug_args.get("mesh_freq", -1))
        self.ckpt_freq = int(cfg.debug_args.get("ckpt_freq", -1))
        self.save_data_freq = int(cfg.debug_args.get("save_data_freq", -1))
        self.recenter_margin = float(tpu.get("recenter_margin", 0.0))
        if self.recenter_margin > 0:
            half_xy = min(shapes["grid_dim"][:2]) * shapes["voxel_size"] / 2
            slack = half_xy - shapes["max_depth"]
            if self.recenter_margin > slack:
                raise ValueError(f"tpu_specs.recenter_margin={self.recenter_margin} exceeds "
                                 f"region slack {slack:.1f} m; rays would leave the grid")
        self.bootstrap_steps = int(tpu["bootstrap_steps"])
        # bias transfer: EMA of BAResult.surface_bias, the next tracked
        # frame's band target, as (2,) [ground, non-ground] (pooled: equal)
        self.bias_correction = q["bias_correction"]
        self.sdf_bias = np.zeros(2, np.float32)
        self.overflow_events = {"capacity": 0, "active": 0, "touched": 0, "cand": 0}
        self.dropped_delta_events = 0
        self.host_syncs = 0  # device -> host reads (the JAX path does one per frame)

        seed = int(tpu["seed"])
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # K5's, K7's and K10b's scratch, kept for the run: K5's (C,) head
        # table is filled once, and again only when the map grows; K7's
        # election grids once, and again only for a larger region or cap;
        # K10b's tile states once, and again only for a larger mesh chunk
        self.reconcile_scratch = vm.ReconcileScratch()
        self.insert_scratch = vm.InsertScratch()
        self.mesh_scratch = TetScratch()
        self.pyrng = pyrandom.Random(seed)
        dec = cfg.decoder_specs
        params = init_decoder(
            depth=int(dec["depth"]), width=int(dec["width"]), in_dim=int(dec["in_dim"]),
            skips=tuple(dec.get("skips", []) or []), embedder=dec.get("embedder", "none"),
            multires=int(dec.get("multires", 0)), generator=self.generator, device=self.device)
        self.state = SlamState(map_state=vm.create(self.map_cfg, self.device),
                               decoder_params=params)

    # ------------------------------------------------------------------ util

    def _fetch(self, *tensors) -> list:
        """One device -> host read of several scalars / small tensors."""
        self.host_syncs += 1
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors])
        vals = flat.cpu().numpy()
        out, i = [], 0
        for t in tensors:
            n = t.numel()
            out.append(vals[i:i + n].reshape(t.shape))
            i += n
        return out

    def _pad_for_ba(self, frames: list, n_frames: int):
        devs = [f.device_arrays(self.device) for f in frames[:n_frames]]
        while len(devs) < n_frames:  # inactive slots reuse slot 0 (masked out)
            devs.append(devs[0])
        pts, cos, val = (torch.stack([d[i] for d in devs]) for i in range(3))
        poses = np.zeros((n_frames, 6), np.float32)
        active = np.zeros((n_frames,), bool)
        for i, f in enumerate(frames[:n_frames]):
            poses[i] = f.pose6
            active[i] = True
        return pts, cos, val, poses, active

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # ----------------------------------------------------------------- mapper

    def _recenter(self, center_world, refresh: bool = True):
        c = self._tensor(center_world)
        st = self.state
        st.map_state = (vm.recenter_refresh(st.map_state, self.map_cfg, c) if refresh
                        else vm.recenter(st.map_state, self.map_cfg, c))

    def create_voxels(self, frame: Frame):
        """Insert one frame at its host pose, growing capacity or the
        candidate budget and re-running the insert on overflow."""
        pts, cos, val = frame.device_arrays(self.device)
        p6 = self._tensor(frame.pose6)
        while True:  # the insert writes into the map; an overflow undoes it first
            ms, rec = vm.insert_frame(self.state.map_state, self.map_cfg, pts, cos, val, p6,
                                      self.insert_cand_cap, self.recenter_margin > 0,
                                      self.insert_scratch)
            num_lat, num_cand = (int(v) for v in self._fetch(ms.num_lat, ms.num_cand))
            if not self._grow_budgets(num_lat, 0, 0, num_cand,
                                      rewind=partial(vm.undo_insert, ms, rec)):
                break
        self.state.map_state = ms

    def _grow_budgets(self, num_lat: int, n_active: int, touched: int, num_cand: int,
                      which: str = "current", rewind=None) -> bool:
        """Grow every budget the counts overflowed, without re-running
        anything (callers replay). Resizes state.map_state; ``rewind``, when
        given, is called first if any budget overflowed (the callers undo
        the insert that wrote into the pre-frame map)."""
        st = self.state
        bp = self.bp_current if which == "current" else self.bp_random
        if not (num_lat > self.map_cfg.capacity or n_active > vm.acap(self.map_cfg)
                or touched > bp.touched_cap or num_cand > self.insert_cand_cap):
            return False
        if rewind is not None:
            rewind()
        if num_lat > self.map_cfg.capacity:
            cap = self.map_cfg.capacity
            while num_lat > cap:
                cap *= 2
            self.overflow_events["capacity"] += 1
            st.map_state, self.map_cfg = vm.grow(st.map_state, self.map_cfg, cap)
        if n_active > vm.acap(self.map_cfg):
            acap_v = vm.acap(self.map_cfg)
            while n_active > acap_v:
                acap_v *= 2
            self.overflow_events["active"] += 1
            self.map_cfg = self.map_cfg._replace(active_cap=min(acap_v, self.map_cfg.capacity))
            st.map_state = vm.refresh_active(st.map_state, self.map_cfg)
        if touched > bp.touched_cap:
            cap = bp.touched_cap
            while touched > cap:
                cap *= 2
            self.overflow_events["touched"] += 1
            bp = bp._replace(touched_cap=min(cap, vm.acap(self.map_cfg)))
            if which == "current":
                self.bp_current = bp
            else:
                self.bp_random = bp
        if num_cand > self.insert_cand_cap:
            cap = self.insert_cand_cap
            while num_cand > cap:
                cap *= 2
            self.overflow_events["cand"] += 1
            self.insert_cand_cap = cap
        return True

    def insert_keyframe(self, frame: Frame):
        kf = frame.cropped(self.key_distance, self.kf_points_pad)
        if kf.n_points < 2 * self.bp_current.n_rays:
            raise ValueError("valid_distance too small")
        self.state.current_keyframe = kf
        self.state.keyframes.append(kf)

    def _ba(self, bp, targets, pose_free, update_decoder):
        st = self.state
        pts, cos, val, poses, active = self._pad_for_ba(targets, bp.n_frames)
        return ba_mod.ba_step(
            st.map_state, self.map_cfg, self.rc_map, bp, st.decoder_params, self._tensor(poses),
            pts, cos, val, self._tensor(active, torch.bool), self._tensor(pose_free, torch.bool),
            bool(update_decoder), self.ba_lrs, self.generator,
            reconcile_scratch=self.reconcile_scratch)

    def _apply_ba(self, res):
        st = self.state
        st.map_state = st.map_state._replace(embeddings=res.embeddings, packed=res.packed,
                                             upd_count=res.upd_count)
        st.decoder_params = res.decoder_params

    def do_mapping(self, tracked_frame: Frame | None, update_pose=True, update_decoder=True,
                   selection_method="current"):
        """One BA step on the tracked frame ("current") or a random
        keyframe window ("random"), with the lossless touched-overflow
        replay (same generator state, grown reconcile budget)."""
        st = self.state
        if selection_method == "current":
            targets, bp, which = [tracked_frame], self.bp_current, "current"
        elif selection_method == "random":
            targets, bp, which = self._select_random_window(), self.bp_random, "random"
            if not targets:
                return None
        else:
            raise NotImplementedError(f"selection_method {selection_method!r} is not ported yet")
        pose_free = [update_pose and f.index != st.first_frame_id for f in targets]
        pose_free += [False] * (bp.n_frames - len(targets))
        gen_state = self.generator.get_state()
        pre = (st.map_state, st.decoder_params)
        while True:
            res = self._ba(bp, targets, pose_free, update_decoder)
            poses_np, touched = self._fetch(res.poses, res.touched_count)
            if not self._grow_budgets(0, 0, int(touched), 0, which):
                break
            bp = self.bp_current if which == "current" else self.bp_random
            self.generator.set_state(gen_state)
            st.map_state, st.decoder_params = pre
        self._apply_ba(res)
        for i, f in enumerate(targets):
            if pose_free[i]:
                f.pose6 = poses_np[i].astype(np.float32)
        return res

    def _select_random_window(self) -> list:
        kfs = self.state.keyframes
        if not kfs:
            return []
        w = self.window_size
        if len(kfs) <= w:
            return kfs[:]
        anchor = self.pyrng.randrange(len(kfs))
        a_t = kfs[anchor].pose6[:3]
        order = sorted(range(len(kfs)),
                       key=lambda i: float(np.linalg.norm(kfs[i].pose6[:3] - a_t)))
        return [kfs[i] for i in order[:w]]

    # --------------------------------------------------------------- pipeline

    def process_first_frame(self, frame: Frame):
        st = self.state
        st.first_frame_id = frame.index
        st.last_frame = frame
        st.tracking_trajectory.append(frame.pose_matrix())
        self._recenter(frame.pose6[:3], refresh=False)
        self.create_voxels(frame)
        st.map_state = vm.refresh_active(st.map_state, self.map_cfg)
        # JAX checks the active set only after tracked frames, so its
        # bootstrap BA trains a truncated set when active_cap is too small;
        # growing it here keeps the first frame lossless too
        (n_active,) = self._fetch(st.map_state.n_active)
        self._grow_budgets(0, int(n_active), 0, 0)
        self.insert_keyframe(frame)
        mapper_frame = self._mapper_copy(frame)
        for _ in range(self.bootstrap_steps):
            self.do_mapping(mapper_frame, selection_method="current")
        self._record_trajectory(mapper_frame)
        st.frames_processed += 1

    @staticmethod
    def _mapper_copy(frame: Frame) -> Frame:
        """The mapper's pose refinements never reach the tracker."""
        return Frame(frame.index, frame.points, frame.points_cos, frame.valid, frame.n_points,
                     frame.pose6.copy(), frame.rel_pose, frame.has_gt_pose, frame.hit_ratio,
                     frame._dev)

    def _record_trajectory(self, mapped_frame: Frame):
        st = self.state
        rel = np.linalg.inv(st.current_keyframe.pose_matrix()) @ mapped_frame.pose_matrix()
        st.frame_poses.append((len(st.keyframes) - 1, rel))

    @staticmethod
    def _pooled_bias(surface_bias) -> float:
        """Count-weighted pooled value of a (2, 2) [biases; counts] probe;
        a scalar (the window probe) passes through (JAX pipeline.py:559)."""
        arr = np.asarray(surface_bias, np.float64)
        if arr.ndim == 0:
            return float(arr)
        b, c = arr[0], arr[1]
        tot = c.sum()
        return float((b * c).sum() / tot) if tot > 0 else float("nan")

    def _update_sdf_bias(self, surface_bias):
        """EMA (0.8 / 0.2) of the measured surface offset into the band
        target (JAX pipeline.py:569-592, bias_classes=1: both entries track
        the pooled value)."""
        if not self.bias_correction:
            return
        sb = self._pooled_bias(surface_bias)
        if np.isfinite(sb):
            self.sdf_bias = (0.8 * self.sdf_bias + 0.2 * sb).astype(np.float32)

    def _track(self, tp, init6, pts, cos, val, sdf_bias):
        st = self.state
        args = (st.map_state, self.map_cfg, self.rc_track, tp, st.decoder_params, init6, pts, cos,
                val)
        if self.track_method == "gn":
            prev = None
            if tp.s2s is not None:  # rasterize the previous scan once per frame
                last = st.last_frame
                prev_pts, _, prev_val = last.device_arrays(self.device)
                prev = build_prev_scan(tp.s2s, prev_pts, prev_val, self._tensor(last.pose6))
            return tr_mod.track_frame_gn(*args, self.generator, sdf_bias, prev)
        lr = self.track_lr * 2 if st.frames_processed < 2 else self.track_lr / 3
        return tr_mod.track_frame(*args, lr, self.generator, sdf_bias)

    def _megastep(self, tp, init6, pts, cos, val, pose_free, update_decoder, sdf_bias):
        """track -> lazy recenter + refresh -> BA(current) -> insert, all on
        the device; returns the new map state, the decoder, the tensors to
        fetch and the insert's record (the insert writes into tables the
        pre-frame state shares: a replay undoes it first)."""
        st = self.state
        cfg = self.map_cfg
        with self.prof.section("track"):
            tr = self._track(tp, init6, pts, cos, val, sdf_bias)
        with self.prof.section("recenter"):
            if self.recenter_margin > 0:
                self.host_syncs += 1  # lax.cond in JAX, a host branch here
                ms = vm.maybe_recenter_refresh(st.map_state, cfg, tr.pose[:3],
                                               self.recenter_margin)
            else:
                ms = vm.recenter_refresh(st.map_state, cfg, tr.pose[:3])
        with self.prof.section("ba"):
            ba = ba_mod.ba_step(ms, cfg, self.rc_map, self.bp_current, st.decoder_params,
                                tr.pose[None], pts[None], cos[None], val[None],
                                torch.ones((1,), dtype=torch.bool, device=self.device),
                                pose_free, update_decoder, self.ba_lrs, self.generator,
                                reconcile_scratch=self.reconcile_scratch)
        ms = ms._replace(embeddings=ba.embeddings, packed=ba.packed, upd_count=ba.upd_count)
        with self.prof.section("insert"):
            ms, rec = vm.insert_frame(ms, cfg, pts, cos, val, ba.poses[0], self.insert_cand_cap,
                                      self.recenter_margin > 0, self.insert_scratch)
        outs = (tr.pose, tr.hit_count, ba.poses[0], ms.num_lat, ms.n_active,
                ba.touched_count, ms.num_cand, tr.loss, ba.surface_bias)
        return ms, ba.decoder_params, outs, rec

    def process_frame(self, frame: Frame):
        """One tracked frame, synchronous: the whole frame runs on the
        device and the host reads its results once at the end."""
        if frame.has_gt_pose:
            raise NotImplementedError("mapping-only frames with GT poses are not ported yet "
                                      "(ROADMAP queue 1, item 15)")
        st = self.state
        mapper_frame = self._mapper_copy(frame)
        update_decoder = (mapper_frame.index - st.first_frame_id) < self.freeze_frame
        last = st.last_frame
        last_T = last.pose_matrix()
        const_T = last_T.copy()
        first = st.rel_pose is None
        if not first:
            if self.const_vel_full:
                const_T = last_T @ st.rel_pose
            else:
                const_T[:3, 3] = (last_T @ st.rel_pose)[:3, 3]
        init6 = self._tensor(pose6_from_matrix_np(const_T))
        tp = self.tp_first if first else self.tp
        pts, cos, val = frame.device_arrays(self.device)
        pose_free_b = frame.index != st.first_frame_id
        pose_free = self._tensor([pose_free_b], torch.bool)
        sdf_bias = self._tensor(self.sdf_bias if self.bias_correction else np.zeros(2, np.float32))

        pre = (st.map_state, st.decoder_params, self.generator.get_state())
        for _ in range(8):  # each round at least doubles a budget
            ms, dec, outs, rec = self._megastep(tp, init6, pts, cos, val, pose_free,
                                                update_decoder, sdf_bias)
            with self.prof.section("sync"):
                got = self._fetch(*outs)
            num_lat, n_active, touched, num_cand = (int(got[i]) for i in (3, 4, 5, 6))
            st.map_state, st.decoder_params = pre[0], pre[1]
            if not self._grow_budgets(num_lat, n_active, touched, num_cand,
                                      rewind=partial(vm.undo_insert, ms, rec)):
                break
            self.generator.set_state(pre[2])
            pre = (st.map_state, st.decoder_params, pre[2])
        else:  # the last round's map update was undone: the frame's deltas are dropped
            self.dropped_delta_events += 1
            ms, dec = pre[0], pre[1]
        st.map_state, st.decoder_params = ms, dec

        frame.pose6 = got[0].astype(np.float32)
        hits = int(got[1])
        if hits > 0:
            frame.hit_ratio = hits / self.tp.n_rays
        st.tracking_trajectory.append(frame.pose_matrix())
        st.rel_pose = np.linalg.inv(last.pose_matrix()) @ frame.pose_matrix()
        frame.rel_pose = st.rel_pose
        st.frame_telemetry.append((frame.index, hits / self.tp.n_rays, float(got[7]),
                                   self._pooled_bias(got[8])))
        self._update_sdf_bias(got[8])  # from the accepted run only
        mapper_frame.pose6 = frame.pose6
        if pose_free_b:
            mapper_frame.pose6 = got[2].astype(np.float32)
        st.last_frame = frame
        self._post_frame(frame, mapper_frame)

    def _post_frame(self, frame: Frame, mapper_frame: Frame):
        """Keyframe-gap insertion, the trajectory record, and the periodic
        mesh / checkpoint / debug dumps."""
        st = self.state
        gap = np.linalg.norm(mapper_frame.pose6[:3] - st.current_keyframe.pose6[:3])
        if gap > self.keyframe_gap:
            self.insert_keyframe(mapper_frame)
        self._record_trajectory(mapper_frame)
        if self.mesh_freq > 0 and frame.index % self.mesh_freq == 0:
            self._mesh_interval(mapper_frame)
        if self.logger is not None and self.ckpt_freq > 0 and frame.index % self.ckpt_freq == 0:
            from nerfloam_tpu_torch.utils.checkpoint import save_checkpoint

            save_checkpoint(os.path.join(self.logger.dir, "ckpt", f"{frame.index:05d}"), self)
        if (self.logger is not None and self.save_data_freq > 0
                and frame.index % self.save_data_freq == 0):
            self.host_syncs += 1
            self.logger.log_debug_data({
                "frame_index": frame.index,
                "pose6": np.asarray(mapper_frame.pose6),
                "num_lat": int(st.map_state.num_lat),
                "n_active": int(st.map_state.n_active),
                "n_keyframes": len(st.keyframes),
            }, frame.index)
        st.frames_processed += 1

    def _replay(self, n_calls: int):
        for _ in range(n_calls):
            kfs = self.state.keyframes
            if kfs:
                self._recenter(kfs[self.pyrng.randrange(len(kfs))].pose6[:3])
            self.do_mapping(None, update_pose=False, update_decoder=False,
                            selection_method="random")

    def _mesh_interval(self, frame: Frame):
        """A periodic mesh and pose dump; with ``final_iter`` and more than
        20 keyframes, a random replay first and a keyframe-graph reset
        after."""
        st = self.state
        did_replay = False
        if self.final_iter and len(st.keyframes) > 20:
            self._replay(len(st.keyframes) + 1)
            did_replay = True
        if self.logger is not None:
            v, f = self.extract_mesh()
            self.logger.log_mesh(v, f, name=f"mesh_{frame.index:05d}.ply")
            self.logger.log_numpy_data(np.asarray(self.get_updated_poses()),
                                       f"frame_poses_{frame.index:05d}")
        if did_replay:  # graph reset
            st.keyframes = [st.current_keyframe]

    def get_updated_poses(self):
        """Flush frame_poses into final_poses."""
        st = self.state
        for kf_idx, rel in st.frame_poses:
            ref = st.keyframes[kf_idx] if kf_idx < len(st.keyframes) else st.current_keyframe
            st.final_poses.append(ref.pose_matrix() @ rel)
        st.frame_poses = []
        return st.final_poses

    def observed_points(self, downsample: float = 0.05) -> np.ndarray:
        """World-frame observed surface points from the keyframe clouds,
        voxel-downsampled: the culling source for ``mesher.clean_mesh``."""
        clouds = []
        for kf in self.state.keyframes:
            T = kf.pose_matrix()
            clouds.append(kf.points[kf.valid] @ T[:3, :3].T + T[:3, 3])
        if not clouds:
            return np.zeros((0, 3), np.float32)
        return mesher.downsample_points(np.concatenate(clouds).astype(np.float32), downsample)

    def extract_mesh(self, res: int | None = None, clean: bool | None = None):
        """The map's triangle mesh (vertices (V, 3), faces (F, 3)); ``clean``
        (default ``mapper_specs.clean_mesh``) culls faces farther than half
        a voxel from every observed keyframe point."""
        with self.prof.section("mesh_extract"):
            tris = mesher.extract_triangles(self.state.map_state, self.map_cfg,
                                            self.state.decoder_params, res or self.mesh_res,
                                            self.compute_dtype, scratch=self.mesh_scratch)
        self.host_syncs += 1
        if len(tris) == 0:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
        with self.prof.section("mesh_weld"):
            v, f = mesher.weld(tris)
        if clean is None:
            clean = bool(self.cfg.mapper_specs.get("clean_mesh", False))
        if clean and len(f):
            with self.prof.section("mesh_clean"):
                f = mesher.clean_mesh(v, f, self.observed_points(),
                                      radius=self.map_cfg.voxel_size * 0.5)
        return v, f

    def finalize(self):
        """End of sequence: the no-replay mesh, the final_iter random
        replay, then the final poses and mesh."""
        if self.logger is not None:
            v, f = self.extract_mesh()
            self.logger.log_mesh(v, f, name="final_mesh_noreplay.ply")
        if self.final_iter:
            with self.prof.section("finalize_replay"):
                self._replay(len(self.state.keyframes) + 1)
        poses = self.get_updated_poses()
        if self.logger is not None:
            self.logger.log_numpy_data(np.asarray(poses), "frame_poses")
            # the tracker's own per-frame odometry, before mapper refinement
            self.logger.log_numpy_data(np.asarray(self.get_raw_trajectory()),
                                       "tracking_trajectory")
            v, f = self.extract_mesh()
            self.logger.log_mesh(v, f, name="final_mesh.ply")
        return poses

    def get_raw_trajectory(self) -> list:
        """The tracker's unrefined per-frame poses."""
        return self.state.tracking_trajectory

    def run(self):
        """The whole sequence; returns the trajectory (list of 4x4)."""
        from nerfloam_tpu_torch.data.prefetch import PrefetchingLoader

        tspec = self.cfg.tracker_specs
        start = int(tspec.get("start_frame", 0))
        end = int(tspec.get("end_frame", -1))
        stride = int(tspec.get("read_offset", 1))
        n = len(self.dataset)
        if end <= 0:
            end = n - 1
        start, end = min(start, n), min(end, n - 1)
        if self.state.frames_processed > 0:  # resumed: go on after the last processed frame
            start = max(start, self.state.last_frame.index)
        else:
            idx, pts, cos, pose = self.dataset[start]
            first = Frame.from_raw(idx, pts, cos, self.dataset.get_init_pose(start),
                                   self.points_pad, has_gt_pose=pose is not None)
            self.process_first_frame(first)
        ids = [i for i in range(start + 1, end + 1) if i % stride == 0]
        for _, (idx, pts, cos, pose) in PrefetchingLoader(self.dataset, ids):
            frame = Frame.from_raw(idx, pts, cos, pose, self.points_pad,
                                   has_gt_pose=pose is not None)
            with self.prof.section("frame"):
                self.process_frame(frame)
        return self.finalize()
