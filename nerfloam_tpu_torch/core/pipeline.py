"""SLAM orchestration (port of nerfloam_tpu/core/pipeline.py): one device,
or with ``tpu_specs.dp`` > 1 one rank of a ``torch.distributed`` group that
splits the GN tracker's and BA's rays (``parallel/sharding.run_dp``).

frame 0: insert -> active refresh -> keyframe -> ``bootstrap_steps`` BA steps.
frame k: track (GN or Adam, ``track_method``) -> lazy recenter + active
refresh -> BA on the tracked frame -> voxel insert (the megastep,
``_mega_dispatch``), then ONE host fetch of the frame's results (poses,
hit count, row counts, the BA's surface-bias probe) and the host
bookkeeping (``_mega_finalize``): the bias EMA and ``_post_frame``'s
keyframe-gap insertion, trajectory record and periodic mesh / checkpoint /
debug dumps.
finalize: the no-replay mesh, the ``final_iter`` random replay, the final
poses and mesh, all written through the run logger when there is one.

``tpu_specs.defer_sync`` (the default) runs the frames one deep, as JAX's
schedule does: frame k is dispatched, then frame k-1 is finalized while the
card runs k. The warm start is computed on the device from the last two
tracked poses (``_const_vel``); keyframe insertion and the bias EMA act one
frame late. A frame's outputs are copied out at its dispatch (the insert of
the next frame overwrites the map's counters in place), into pinned memory
without blocking, and its finalize waits on that copy's event alone. An
overflow found at finalize while a newer frame is in flight undoes the
newer frame's insert, then the older's, puts back the older frame's
pre-frame state, grows the budgets and replays the older frame, then the
newer one on top, each from its own saved generator state
(``_defer_replays`` counts them). ``_drain`` finalizes the frame in flight
before anything that needs the loop caught up: a replay step, a mesh, a
checkpoint, a ground-truth frame, ``finalize``.

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

The off-by-default knobs are ported: ``replay_freq`` (a BA step over a
random keyframe window every n frames, then a recenter on the vehicle),
``ba_pose_project=along`` (BA's translation update kept off the tracked
motion direction, computed on the device inside the frame), the BA-delta
telemetry (each tracked frame's BA refinement in the motion frame, on the
host in float64), ``remove_back`` (the mapper's copy of a frame drops
far points behind the motion; BA and the insert take its mask, the
tracker the full one), mapping-only frames on ground-truth poses
(``data_specs.use_gt``: no tracker; recenter, BA, insert, one host read)
and the decoder's skips and positional embedders (``DecoderMeta``).

The reference-exact fallbacks (``docs/PERF.md:157-159``) are ported:
``exact_embedding_grads`` (BA on the canonical table through E1; f32
embeddings only: the JAX package's BA loop cannot carry a bf16 table on
that path), ``ba_ray_superset=0``, ``track_resample_rays`` (the Adam
tracker's; the GN tracker ignores it, as JAX's does) and
``reconcile_mode=sum``.

Every budget overflow (capacity, active set, touched voxels, insert
candidates) is handled as in JAX: rewind the frame to its pre-frame state,
grow the budget and replay the frame with the same random stream
(the generator state is saved with the map), so growth never loses data.

The knobs measured and dropped in the JAX package's rounds are ported too:
``maturity_warmup`` / ``maturity_floor`` (the GN tracker weighs each sample
by its voxel's BA-touch count, K3's maturity form), ``bias_source=keyframe``
(the bias probe at the current keyframe's points on the post-BA field,
``ba.surface_bias_at``, in place of BA's window probe) and
``bias_classes=2`` (separate ground / non-ground EMAs of that probe); and
``do_mapping``'s ``selection_method="previous"`` (the last ``window_size``
keyframes).
"""

from __future__ import annotations

import os
import random as pyrandom
from dataclasses import dataclass, field
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from nerfloam_tpu_torch.core import ba as ba_mod
from nerfloam_tpu_torch.core import tracking as tr_mod
from nerfloam_tpu_torch.core.frame import Frame, pose6_from_matrix_np, upload
from nerfloam_tpu_torch.core.scan2scan import Scan2ScanParams, build_prev_scan
from nerfloam_tpu_torch.map import mesher
from nerfloam_tpu_torch.map import voxel_map as vm
from nerfloam_tpu_torch.models.decoder import PLAIN, DecoderMeta, init_decoder
from nerfloam_tpu_torch.ops import se3
from nerfloam_tpu_torch.ops.ieee import norm3
from nerfloam_tpu_torch.ops.marching import TetScratch
from nerfloam_tpu_torch.ops.raycast import RaycastConfig
from nerfloam_tpu_torch.utils.config import Config, derive_static_shapes, quality_knobs
from nerfloam_tpu_torch.utils.profiler import Profiler

def _const_vel(last6: torch.Tensor, prev6: torch.Tensor, full: bool) -> torch.Tensor:
    """The constant-velocity warm start on the device from the raw tracked
    poses of the two previous frames (JAX ``_const_vel_jit``, pipeline.py:
    60-72): rel = inv(T_prev) T_last, init = T_last rel; ``full=False``
    moves the translation only."""
    t_last = se3.pose_matrix(last6)
    t_prev = se3.pose_matrix(prev6)
    rel = se3.compose_matrices(se3.invert_matrix(t_prev), t_last)
    t_const = se3.compose_matrices(t_last, rel)
    if not full:
        t_const = torch.cat([torch.cat([t_last[:3, :3], t_const[:3, 3:]], 1), t_last[3:]], 0)
    return se3.pose_from_matrix(t_const)


class _Staged:
    """Small device tensors copied out in one piece: float64 values in a
    host buffer (pinned, filled by a copy that does not block, with an
    event after it, on the card), their shapes, and that event."""

    __slots__ = ("host", "shapes", "event")

    def __init__(self, host, shapes, event):
        self.host, self.shapes, self.event = host, shapes, event


class _Dispatch:
    """One tracked frame's megastep (JAX's dispatch record, pipeline.py:
    1250-1275): the frame, its mapper copy, the previous frame, its
    TrackParams and whether BA frees its pose; the megastep's device inputs
    (``args``); the state before it (``pre``: map state and decoder) and the
    generator's state before it; the state after it (``post``), its K7
    ``InsertRecord`` and its outputs, staged at dispatch."""

    __slots__ = ("frame", "mapper_frame", "prev_frame", "tp", "pose_free", "args", "pre",
                 "gen_state", "post", "insert", "outs")

    def __init__(self, frame, mapper_frame, prev_frame, tp, pose_free, args, pre, gen_state):
        self.frame, self.mapper_frame, self.prev_frame = frame, mapper_frame, prev_frame
        self.tp, self.pose_free, self.args = tp, pose_free, args
        self.pre, self.gen_state = pre, gen_state
        self.post = self.insert = self.outs = None


@dataclass
class SlamState:
    map_state: vm.MapState
    decoder_params: dict
    decoder_meta: DecoderMeta = PLAIN
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
    ba_delta_telemetry: list = field(default_factory=list)  # (index, along_m, lat_m,
    #   dz_m) per tracked frame whose BA freed the pose: BA's pose minus the
    #   tracker's, in the motion frame (JAX SlamState.ba_delta_telemetry)


class NerfLoamSLAM_torch:
    def __init__(self, cfg: Config, dataset, device, logger=None):
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
                       surface_anchor=q["surface_anchor"], band_samples=q["band_samples"],
                       resample_rays=bool(tpu.get("track_resample_rays", False)),
                       maturity_warmup=int(tpu.get("maturity_warmup", 0)),
                       maturity_floor=float(tpu.get("maturity_floor", 0.25)))
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
        exact = bool(tpu.get("exact_embedding_grads", False))
        if exact and self.map_cfg.emb_dtype != "float32":
            raise ValueError(
                "tpu_specs.exact_embedding_grads needs tpu_specs.emb_dtype=float32: the JAX "
                "package's BA loop cannot run it on a bfloat16 table (its f32 learning rate "
                "promotes the table, and the loop carry bfloat16[C,F] comes back "
                "float32[C,F]: nerfloam_tpu/core/ba.py:357)")
        reconcile_mode = str(tpu.get("reconcile_mode", "mean"))
        if reconcile_mode not in vm.RECONCILE_MODES:
            raise ValueError(f"tpu_specs.reconcile_mode must be 'mean' or 'sum', "
                             f"got {reconcile_mode!r}")
        # where the bias transfer's offset is measured (JAX pipeline.py:
        # 229-248): "window", BA's probe of its own points on the post-BA
        # field; "keyframe", the current keyframe's points (surface_bias_at)
        self.bias_source = str(tpu.get("bias_source", "window"))
        if self.bias_source not in ("window", "keyframe"):
            raise ValueError(f"tpu_specs.bias_source must be 'window' or 'keyframe', "
                             f"got {self.bias_source!r}")
        self.bias_classes = int(tpu.get("bias_classes", 1))
        if self.bias_classes == 2 and self.bias_source != "keyframe":
            raise ValueError(
                "tpu_specs.bias_classes=2 requires bias_source='keyframe' (the window probe is "
                "pooled; its per-class split was measured worse — docs/PERF.md round-2)")
        base_bp = dict(truncation=float(crit["sdf_truncation"]), max_depth=shapes["max_depth"],
                       fs_weight=float(crit["fs_weight"]), sdf_weight=float(crit["sdf_weight"]),
                       compute_dtype=self.compute_dtype,
                       ray_superset=int(tpu.get("ba_ray_superset", 2)),
                       surface_anchor=q["surface_anchor"], band_samples=q["band_samples"],
                       measure_bias=q["bias_correction"] and self.bias_source == "window",
                       exact_embedding_grads=exact,
                       reconcile_mode=reconcile_mode)
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
        self.remove_back = bool(mspec.get("remove_back", False))
        self.replay_freq = int(tpu.get("replay_freq", 0))
        self.defer_sync = bool(tpu.get("defer_sync", True))
        self._inflight = None        # the dispatched, not yet finalized frame (_Dispatch)
        self._dev_last_pose6 = None  # defer_sync: raw tracked pose of the last dispatched frame
        self._dev_prev_pose6 = None  # ... and of the frame before it (device tensors)
        self._defer_replays = 0      # overflows found with a newer frame in flight
        self.ba_pose_project = str(tpu.get("ba_pose_project", "none"))
        if self.ba_pose_project not in ("none", "along"):
            raise ValueError(f"tpu_specs.ba_pose_project must be 'none' or 'along', "
                             f"got {self.ba_pose_project!r}")
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
        # ray data parallelism (JAX pipeline.py:384-398, 1055-1061): the GN
        # tracker and every BA step split their rays over the ranks of the
        # process group that parallel.sharding.run_dp starts; only rank 0
        # writes the logger's files
        self.dp = int(tpu.get("dp", 1))
        self.group = None
        if self.dp > 1:
            if not (dist.is_available() and dist.is_initialized()):
                raise ValueError(
                    f"tpu_specs.dp={self.dp} needs a torch.distributed process group of "
                    f"{self.dp} ranks, one a process: start them with "
                    "nerfloam_tpu_torch.parallel.sharding.run_dp")
            if dist.get_world_size() != self.dp:
                raise ValueError(f"tpu_specs.dp={self.dp} but the process group has "
                                 f"{dist.get_world_size()} ranks")
            for n, lbl in ((self.tp.n_rays, "tracker"), (self.bp_current.n_rays, "mapper")):
                if n % self.dp != 0:
                    raise ValueError(f"{lbl} N_rays {n} not divisible by dp {self.dp}")
            self.group = dist.group.WORLD
            if dist.get_rank() != 0:
                self.logger = None
        # bias transfer: EMA of the probe (BAResult.surface_bias, or the
        # keyframe's surface_bias_at), the next tracked frame's band target,
        # as (2,) [ground, non-ground] (pooled: equal)
        self.bias_correction = q["bias_correction"]
        self.kf_bias = self.bias_correction and self.bias_source == "keyframe"
        self.sdf_bias = np.zeros(2, np.float32)
        self.overflow_events = {"capacity": 0, "active": 0, "touched": 0, "cand": 0}
        self.dropped_delta_events = 0
        self.host_syncs = 0  # device -> host reads (the JAX path does one per frame)

        seed = int(tpu["seed"])
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # K5's, E1's, K7's and K10b's scratch, kept for the run: K5's and
        # E1's (C,) head tables are filled once, and again only when the map
        # grows; K7's election grids once, and again only for a larger
        # region or cap; K10b's tile states once, and again only for a
        # larger mesh chunk
        self.reconcile_scratch = vm.ReconcileScratch()
        self.pack_scratch = vm.PackGradScratch()
        self.insert_scratch = vm.InsertScratch()
        self.mesh_scratch = TetScratch()
        self.pyrng = pyrandom.Random(seed)
        dec = cfg.decoder_specs
        meta = DecoderMeta(tuple(dec.get("skips", []) or []), str(dec.get("embedder", "none")),
                           int(dec.get("multires", 0)))
        params = init_decoder(
            depth=int(dec["depth"]), width=int(dec["width"]), in_dim=int(dec["in_dim"]),
            skips=meta.skips, embedder=meta.embedder, multires=meta.multires,
            generator=self.generator, device=self.device)
        self.state = SlamState(map_state=vm.create(self.map_cfg, self.device),
                               decoder_params=params, decoder_meta=meta)

    # ------------------------------------------------------------------ util

    def _stage(self, *tensors) -> _Staged:
        """Copy several scalars / small tensors out, as they are now: one
        float64 buffer made on the device (so a later in-place write cannot
        reach it), and on the card copied into pinned host memory without
        blocking, an event recorded after the copy."""
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors])
        shapes = [t.shape for t in tensors]
        if flat.device.type != "cuda":
            return _Staged(flat, shapes, None)
        host = torch.empty(flat.shape, dtype=torch.float64, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _Staged(host, shapes, event)

    def _collect(self, staged: _Staged) -> list:
        """The staged values as numpy arrays: one device -> host read, which
        waits for the staging copy's event only."""
        self.host_syncs += 1
        if staged.event is not None:
            staged.event.synchronize()
        vals = staged.host.numpy()
        out, i = [], 0
        for shape in staged.shapes:
            n = int(np.prod(shape, dtype=np.int64))
            out.append(vals[i:i + n].reshape(shape))
            i += n
        return out

    def _fetch(self, *tensors) -> list:
        """One device -> host read of several scalars / small tensors."""
        return self._collect(self._stage(*tensors))

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
        return upload(x, self.device, dtype)

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

    def _overflowed(self, num_lat: int, n_active: int, touched: int, num_cand: int,
                    bp=None) -> bool:
        """Whether the counts overflow a budget (``bp``'s touched cap, the
        current BA's by default)."""
        bp = self.bp_current if bp is None else bp
        return (num_lat > self.map_cfg.capacity or n_active > vm.acap(self.map_cfg)
                or touched > bp.touched_cap or num_cand > self.insert_cand_cap)

    def _grow_budgets(self, num_lat: int, n_active: int, touched: int, num_cand: int,
                      which: str = "current", rewind=None) -> bool:
        """Grow every budget the counts overflowed, without re-running
        anything (callers replay). Resizes state.map_state; ``rewind``, when
        given, is called first if any budget overflowed (the callers undo
        the insert that wrote into the pre-frame map)."""
        st = self.state
        bp = self.bp_current if which == "current" else self.bp_random
        if not self._overflowed(num_lat, n_active, touched, num_cand, bp):
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
            reconcile_scratch=self.reconcile_scratch, pack_scratch=self.pack_scratch,
            dec_meta=st.decoder_meta, group=self.group)

    def _apply_ba(self, res):
        st = self.state
        st.map_state = st.map_state._replace(embeddings=res.embeddings, packed=res.packed,
                                             upd_count=res.upd_count)
        st.decoder_params = res.decoder_params

    def do_mapping(self, tracked_frame: Frame | None, update_pose=True, update_decoder=True,
                   selection_method="current"):
        """One BA step on the tracked frame ("current"), a random keyframe
        window ("random") or the last ``window_size`` keyframes
        ("previous"; JAX pipeline.py:722-733), with the lossless
        touched-overflow replay (same generator state, grown reconcile
        budget). The two windows share ``bp_random`` and its overflow
        class."""
        st = self.state
        if selection_method == "current":
            targets, bp, which = [tracked_frame], self.bp_current, "current"
        elif selection_method in ("random", "previous"):
            targets = (self._select_random_window() if selection_method == "random"
                       else self._select_previous_window())
            bp, which = self.bp_random, "random"
            if not targets:
                return None
        else:
            raise NotImplementedError(selection_method)
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

    def _select_previous_window(self) -> list:
        """The last ``window_size`` keyframes (JAX pipeline.py:831-837): a
        keyframe replay window, the tracked frame not in it."""
        kfs = self.state.keyframes
        return kfs[-self.window_size:] if kfs else []

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
        target (JAX pipeline.py:566-590): bias_classes=1, both entries track
        the pooled value; bias_classes=2 (the keyframe probe's (2, 2)), each
        class its own mean, a class with no sample this frame keeping its
        estimate."""
        if not self.bias_correction:
            return
        arr = np.asarray(surface_bias, np.float64)
        if self.bias_classes == 2 and arr.ndim == 2:
            b, c = arr[0], arr[1]
            upd = (c > 0) & np.isfinite(b)
            self.sdf_bias = np.where(upd, 0.8 * self.sdf_bias + 0.2 * b,
                                     self.sdf_bias).astype(np.float32)
            return
        sb = self._pooled_bias(surface_bias)
        if np.isfinite(sb):
            self.sdf_bias = (0.8 * self.sdf_bias + 0.2 * sb).astype(np.float32)

    def _kf_probe(self, kf: Frame | None):
        """The current keyframe's (points, cosines, mask, pose6) on the
        device for the keyframe bias probe, or None without it."""
        if not self.kf_bias:
            return None
        pts, cos, val = kf.device_arrays(self.device)
        return pts, cos, val, self._tensor(kf.pose6)

    def _surface_bias(self, ms, dec, probe, window_bias):
        """The frame's bias probe: ``ba.surface_bias_at`` at the keyframe's
        points (``probe`` from ``_kf_probe``) on the map ``ms`` and decoder
        ``dec``, or BA's window probe ``window_bias``."""
        if probe is None:
            return window_bias
        pts, cos, val, pose6 = probe
        return ba_mod.surface_bias_at(ms, self.map_cfg, dec, self.state.decoder_meta, pose6,
                                      pts, val, self.rc_map.max_depth, points_cos=cos)

    def _track(self, tp, init6, lr, pts, cos, val, sdf_bias, prev_frame, prev_pose6):
        st = self.state
        args = (st.map_state, self.map_cfg, self.rc_track, tp, st.decoder_params, init6, pts, cos,
                val)
        if self.track_method == "gn":
            prev = None
            if tp.s2s is not None:  # rasterize the previous scan once per frame
                prev_pts, _, prev_val = prev_frame.device_arrays(self.device)
                prev = build_prev_scan(tp.s2s, prev_pts, prev_val, prev_pose6)
            return tr_mod.track_frame_gn(*args, self.generator, sdf_bias, prev,
                                         dec_meta=st.decoder_meta, group=self.group)
        # the Adam tracker runs whole on every rank (JAX: only BA is sharded,
        # pipeline.py:1089-1105)
        return tr_mod.track_frame(*args, lr, self.generator, sdf_bias, dec_meta=st.decoder_meta)

    @staticmethod
    def _along_dir(pose6, prev_pose6):
        """The tracked motion direction (1, 3) on the device, or zero for
        a frame that moved 1e-6 m or less (JAX pipeline.py:1005-1019):
        BA's ``proj_dir`` under ``ba_pose_project=along``."""
        mvec = pose6[:3] - prev_pose6[:3]
        n = norm3(mvec)
        fwd = torch.where(n > 1e-6, mvec / torch.clamp(n, min=1e-9), torch.zeros_like(mvec))
        return fwd[None]

    def _megastep(self, rec: _Dispatch):
        """track -> lazy recenter + refresh -> BA(current) -> insert, all on
        the device; returns the new map state, the decoder, the tensors to
        fetch and the insert's record (the insert writes into tables the
        pre-frame state shares: a replay undoes it first). The tracker takes
        the frame's mask ``val``, BA and the insert the mapper's ``val_m``
        (``remove_back``); ``prev_pose6`` is the previous tracked pose on the
        device (the s2s term's previous scan and ``ba_pose_project=along``'s
        direction; else None)."""
        st = self.state
        cfg = self.map_cfg
        (init6, lr, pts, cos, val, val_m, pose_free, update_decoder, sdf_bias, kf,
         prev_pose6) = rec.args
        with self.prof.section("track"):
            tr = self._track(rec.tp, init6, lr, pts, cos, val, sdf_bias, rec.prev_frame,
                             prev_pose6)
        with self.prof.section("recenter"):
            if self.recenter_margin > 0:
                self.host_syncs += 1  # lax.cond in JAX, a host branch here
                ms = vm.maybe_recenter_refresh(st.map_state, cfg, tr.pose[:3],
                                               self.recenter_margin)
            else:
                ms = vm.recenter_refresh(st.map_state, cfg, tr.pose[:3])
        with self.prof.section("ba"):
            proj = (self._along_dir(tr.pose, prev_pose6) if self.ba_pose_project == "along"
                    else None)
            ba = ba_mod.ba_step(ms, cfg, self.rc_map, self.bp_current, st.decoder_params,
                                tr.pose[None], pts[None], cos[None], val_m[None],
                                torch.ones((1,), dtype=torch.bool, device=self.device),
                                pose_free, update_decoder, self.ba_lrs, self.generator,
                                proj_dir=proj, reconcile_scratch=self.reconcile_scratch,
                                pack_scratch=self.pack_scratch, dec_meta=st.decoder_meta,
                                group=self.group)
        ms = ms._replace(embeddings=ba.embeddings, packed=ba.packed, upd_count=ba.upd_count)
        # the keyframe probe on the post-BA field, before the insert (JAX :1028-1040)
        surface_bias = self._surface_bias(ms, ba.decoder_params, kf, ba.surface_bias)
        with self.prof.section("insert"):
            ms, ins = vm.insert_frame(ms, cfg, pts, cos, val_m, ba.poses[0], self.insert_cand_cap,
                                      self.recenter_margin > 0, self.insert_scratch)
        outs = (tr.pose, tr.hit_count, ba.poses[0], ms.num_lat, ms.n_active,
                ba.touched_count, ms.num_cand, tr.loss, surface_bias)
        return ms, ba.decoder_params, outs, ins

    def process_frame(self, frame: Frame):
        """One frame. A tracked frame is dispatched (``_mega_dispatch``).
        The synchronous schedule finalizes it at once; under ``defer_sync``
        the frame dispatched before it is finalized instead (JAX
        pipeline.py:1069-1102). A frame with a ground-truth pose is mapped
        without the tracker (``_process_gt_frame``), after the frame in
        flight."""
        st = self.state
        mapper_frame = self._mapper_copy(frame)
        if self.remove_back:
            # JAX's order: the new frame has no rel_pose yet, so the rule
            # takes its default motion (+x); a GT frame's is set after
            mapper_frame = mapper_frame.without_back_points(self.key_distance)
        update_decoder = (mapper_frame.index - st.first_frame_id) < self.freeze_frame
        if frame.has_gt_pose:
            self._drain()
            return self._process_gt_frame(frame, mapper_frame, update_decoder)
        rec = self._mega_dispatch(frame, mapper_frame, update_decoder)
        if self.defer_sync:
            prev, self._inflight = self._inflight, rec
            if prev is not None:
                self._mega_finalize(prev)
        else:
            self._mega_finalize(rec)

    def _mega_dispatch(self, frame: Frame, mapper_frame: Frame,
                       update_decoder: bool) -> _Dispatch:
        """Enqueue one tracked frame's megastep and return its record (JAX
        pipeline.py:1200-1284). Under ``defer_sync`` the warm start comes
        from the device poses of the two frames before (``_const_vel``), so
        nothing of the frame in flight is read; after a resume or a switch
        from ground-truth frames it is seeded from the host state. The
        tracker's chain state (``last_frame``) moves on at dispatch."""
        st = self.state
        last = st.last_frame
        first = st.rel_pose is None and self._dev_last_pose6 is None
        if self.defer_sync:
            if first:
                init6 = self._tensor(last.pose6)
                prev_pose6 = init6
            else:
                dev_last, dev_prev = self._dev_last_pose6, self._dev_prev_pose6
                if dev_last is None:  # seed from the host (resume / GT -> tracked)
                    dev_last = self._tensor(last.pose6)
                    dev_prev = self._tensor(pose6_from_matrix_np(
                        last.pose_matrix() @ np.linalg.inv(st.rel_pose)))
                init6 = _const_vel(dev_last, dev_prev, self.const_vel_full)
                prev_pose6 = dev_last
        else:
            last_T = last.pose_matrix()
            const_T = last_T.copy()
            if not first:
                if self.const_vel_full:
                    const_T = last_T @ st.rel_pose
                else:
                    const_T[:3, 3] = (last_T @ st.rel_pose)[:3, 3]
            init6 = self._tensor(pose6_from_matrix_np(const_T))
            prev_pose6 = (self._tensor(last.pose6)
                          if self.tp.s2s is not None or self.ba_pose_project == "along" else None)
        # the frame count as the finalized frames will stand once the frame in
        # flight is done (JAX :1247-1248): the Adam tracker's learning rate
        eff = st.frames_processed + (1 if self._inflight is not None else 0)
        lr = self.track_lr * 2 if eff < 2 else self.track_lr / 3
        pts, cos, val = frame.device_arrays(self.device)
        val_m = mapper_frame.device_arrays(self.device)[2] if self.remove_back else val
        pose_free = frame.index != st.first_frame_id
        sdf_bias = self._tensor(self.sdf_bias if self.bias_correction else np.zeros(2, np.float32))
        args = (init6, lr, pts, cos, val, val_m, self._tensor([pose_free], torch.bool),
                bool(update_decoder), sdf_bias, self._kf_probe(st.current_keyframe), prev_pose6)
        rec = _Dispatch(frame, mapper_frame, last, self.tp_first if first else self.tp, pose_free,
                        args, (st.map_state, st.decoder_params), self.generator.get_state())
        self._mega_run(rec)
        st.last_frame = frame
        return rec

    def _mega_run(self, rec: _Dispatch):
        """Run the megastep of a record on the current state (its dispatch,
        or a replay after an overflow) and stage its outputs at once, before
        anything of a newer frame is enqueued: the newer insert writes the
        map's counters in place."""
        st = self.state
        ms, dec, outs, ins = self._megastep(rec)
        rec.post, rec.insert, rec.outs = (ms, dec), ins, self._stage(*outs)
        st.map_state, st.decoder_params = ms, dec
        if self.defer_sync:  # the device pose recurrence of the next warm start
            self._dev_prev_pose6, self._dev_last_pose6 = rec.args[-1], outs[0]

    def _mega_finalize(self, rec: _Dispatch):
        """Read a dispatched frame's outputs and do its host bookkeeping
        (JAX pipeline.py:1315-1393). An overflow is handled first: with a
        newer frame in flight, its insert is undone before this frame's;
        this frame's pre-frame state is put back, the budgets grown and the
        frame replayed from its own generator state (up to eight rounds;
        past them its deltas are dropped and counted); then the newer frame
        is replayed on top from its own. The bookkeeping reads the final
        outputs."""
        st = self.state
        frame, mapper_frame = rec.frame, rec.mapper_frame
        with self.prof.section("sync"):
            got = self._collect(rec.outs)
        counts = [int(got[i]) for i in (3, 4, 5, 6)]
        if self._overflowed(*counts):
            newer = self._inflight if self._inflight is not rec else None
            if newer is not None:  # it wrote into the tables this frame's state shares
                vm.undo_insert(newer.post[0], newer.insert)
            for round_ in range(8):  # each round at least doubles a budget
                st.map_state, st.decoder_params = rec.pre
                self._grow_budgets(*counts, rewind=partial(vm.undo_insert, rec.post[0],
                                                           rec.insert))
                rec.pre = (st.map_state, st.decoder_params)
                if round_ == 7:  # the last round's map update was undone: its deltas are dropped
                    self.dropped_delta_events += 1
                    break
                self.generator.set_state(rec.gen_state)
                self._mega_run(rec)
                got = self._collect(rec.outs)
                counts = [int(got[i]) for i in (3, 4, 5, 6)]
                if not self._overflowed(*counts):
                    break
            if newer is not None:
                newer.pre = (st.map_state, st.decoder_params)
                self.generator.set_state(newer.gen_state)
                self._mega_run(newer)
                self._defer_replays += 1

        frame.pose6 = got[0].astype(np.float32)
        hits = int(got[1])
        if hits > 0:
            frame.hit_ratio = hits / self.tp.n_rays
        st.tracking_trajectory.append(frame.pose_matrix())
        st.rel_pose = np.linalg.inv(rec.prev_frame.pose_matrix()) @ frame.pose_matrix()
        frame.rel_pose = st.rel_pose
        st.frame_telemetry.append((frame.index, hits / self.tp.n_rays, float(got[7]),
                                   self._pooled_bias(got[8])))
        self._update_sdf_bias(got[8])  # from the accepted run only
        mapper_frame.pose6 = frame.pose6
        if rec.pose_free:
            mapper_frame.pose6 = got[2].astype(np.float32)
            self._record_ba_delta(frame, mapper_frame, rec.prev_frame.pose6)
        # release the pre-frame generation so that its tables can be freed
        rec.pre = rec.post = rec.insert = None
        self._post_frame(frame, mapper_frame)

    def _drain(self):
        """Finalize the frame in flight, if any (``defer_sync``): before
        host work that needs the frame loop caught up."""
        rec, self._inflight = self._inflight, None
        if rec is not None:
            self._mega_finalize(rec)

    def _process_gt_frame(self, frame: Frame, mapper_frame: Frame, update_decoder: bool):
        """A mapping-only frame at its ground-truth pose (JAX pipeline.py:
        1104-1175): no tracker; recenter on the pose, one BA step on the
        mapper's copy that refines it, the insert at BA's pose, one host
        read; the tracker's motion state and trajectory kept from the GT
        poses. An overflow rewinds and replays the frame as a tracked one's
        does (the insert undone, the map, decoder and generator put back,
        the budgets grown)."""
        st = self.state
        targets, bp = [mapper_frame], self.bp_current
        pose_free = [frame.index != st.first_frame_id]
        pts, cos, val = mapper_frame.device_arrays(self.device)
        pre = (st.map_state, st.decoder_params, self.generator.get_state())
        probe = self._kf_probe(st.current_keyframe)
        for round_ in range(8):  # each round at least doubles a budget
            with self.prof.section("recenter"):
                self._recenter(frame.pose6[:3])
            with self.prof.section("do_mapping"):
                res = self._ba(bp, targets, pose_free, update_decoder)
                ms = st.map_state._replace(embeddings=res.embeddings, packed=res.packed,
                                           upd_count=res.upd_count)
            # the keyframe probe on the post-BA field before the insert (JAX
            # :1121-1130); a replayed round measures after it, as JAX's
            # touched-overflow retry does (:1182-1190)
            if round_ == 0:
                bias = self._surface_bias(ms, res.decoder_params, probe, res.surface_bias)
            with self.prof.section("create_voxels"):
                ms, rec = vm.insert_frame(ms, self.map_cfg, pts, cos, val, res.poses[0],
                                          self.insert_cand_cap, self.recenter_margin > 0,
                                          self.insert_scratch)
            if round_ > 0:
                bias = self._surface_bias(ms, res.decoder_params, probe, res.surface_bias)
            with self.prof.section("sync"):
                got = self._fetch(res.poses, ms.num_lat, ms.n_active, res.touched_count,
                                  ms.num_cand, bias)
            num_lat, n_active, touched, num_cand = (int(got[i]) for i in (1, 2, 3, 4))
            st.map_state, st.decoder_params = pre[0], pre[1]
            if not self._grow_budgets(num_lat, n_active, touched, num_cand,
                                      rewind=partial(vm.undo_insert, ms, rec)):
                break
            bp = self.bp_current
            self.generator.set_state(pre[2])
            pre = (st.map_state, st.decoder_params, pre[2])
        else:  # the last round's map update was undone: the frame's deltas are dropped
            self.dropped_delta_events += 1
            ms, res = pre[0], None
        st.map_state = ms
        if res is not None:
            st.decoder_params = res.decoder_params
            self._update_sdf_bias(got[5])
        # the tracker's motion state, kept from the GT poses (JAX :1151-1161)
        st.rel_pose = np.linalg.inv(st.last_frame.pose_matrix()) @ frame.pose_matrix()
        frame.rel_pose = mapper_frame.rel_pose = st.rel_pose
        st.last_frame = frame
        st.tracking_trajectory.append(frame.pose_matrix())
        if res is not None and pose_free[0]:
            mapper_frame.pose6 = got[0][0].astype(np.float32)
        self._post_frame(frame, mapper_frame)

    def _record_ba_delta(self, frame: Frame, mapper_frame: Frame, prev_pose6: np.ndarray):
        """BA-delta telemetry (JAX pipeline.py:805-830): the current-frame
        BA step's pose refinement (mapper pose minus tracker pose) in the
        motion frame, in float64 on the host: along-track from the previous
        frame's translation, lateral = up x fwd, dz = world z. Under
        ``ba_pose_project=along`` its along column reads ~0."""
        d = mapper_frame.pose6[:3].astype(np.float64) - frame.pose6[:3]
        m = frame.pose6[:3].astype(np.float64) - prev_pose6[:3]
        n = np.linalg.norm(m)
        if n < 1e-9:
            fwd = np.zeros(3)
            lat = np.zeros(3)
        else:
            fwd = m / n
            lat = np.cross([0.0, 0.0, 1.0], fwd)
            lat /= np.linalg.norm(lat) + 1e-12
        self.state.ba_delta_telemetry.append(
            (frame.index, float(d @ fwd), float(d @ lat), float(d[2])))

    def _post_frame(self, frame: Frame, mapper_frame: Frame):
        """Keyframe-gap insertion, the trajectory record, and the periodic
        replay, mesh, checkpoint and debug dumps. Under ``defer_sync`` the
        replay, the mesh and the checkpoint drain the frame in flight first,
        whose own ``_post_frame`` then runs inside this one (JAX pipeline.py:
        1403-1467): the trajectory is recorded before that."""
        st = self.state
        gap = np.linalg.norm(mapper_frame.pose6[:3] - st.current_keyframe.pose6[:3])
        if gap > self.keyframe_gap:
            self.insert_keyframe(mapper_frame)
        self._record_trajectory(mapper_frame)
        if (self.replay_freq > 0 and len(st.keyframes) > 1
                and st.frames_processed % self.replay_freq == 0):
            with self.prof.section("replay"):
                # a replay step between two frames in flight would be erased by
                # an overflow rewind of the older one
                self._drain()
                self._replay(1)
                # the replay recentered on a random keyframe: back around the vehicle
                self._recenter(mapper_frame.pose6[:3])
        if self.mesh_freq > 0 and frame.index % self.mesh_freq == 0:
            self._drain()
            self._mesh_interval(mapper_frame)
        if self.logger is not None and self.ckpt_freq > 0 and frame.index % self.ckpt_freq == 0:
            from nerfloam_tpu_torch.utils.checkpoint import save_checkpoint

            self._drain()
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
                                            self.compute_dtype, scratch=self.mesh_scratch,
                                            dec_meta=self.state.decoder_meta)
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
        """End of sequence: the frame in flight finalized, the no-replay
        mesh, the final_iter random replay, then the final poses and mesh."""
        self._drain()
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
