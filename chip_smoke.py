#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Refuses to run without CUDA. Prints the card's name and power limit.
2. Builds the port's kernels (nerfloam_tpu_torch/csrc/*.cu), one nvcc per
   source, all at once, and prints the build seconds.
3. Kernel phase, at the shapes of the quality-stack config on a map built
   by inserting the first frames of the synthetic world with support
   voxels: K4 (hit table at 2048 and 4096 rays, with one origin per ray
   and with one origin expanded to every ray, unpacked and in BA's packed
   form; cdf equal to the running f32 sum of the twin's seg; each form
   timed beside its bound), K1 (hits field; the trackers' 2048 x 64 with one
   origin expanded to every ray, row stride 0, timed, and BA's 2048 x 48),
   K2 (its backward: d packed bit-identical across two calls through one
   DpackedScratch, as a BA step keeps it, and equal to
   render.dpacked_in_row_order_plain, here and at the replica gate's BA
   shape; the samples per touched row and the host us of K1's and K2's
   wrapper pieces printed), K8 (active
   field through one ActiveField: band columns with one origin per ray and
   with the trackers' one origin expanded to every ray, the bias probe, and
   the replica gate tracker's grid and band columns; every output equal
   from call to call), K3 (GN normal equations through one GnSystem a
   shape, at the quality tracker's and the replica gate tracker's columns:
   bit-identical between calls and to a fresh GnSystem, its last-block
   counter back to zero; the host us of both objects, their function forms
   and the conversions their earlier wrappers made printed), K7
   (voxel insert, in place: the kernel and the twin each on a clone of
   the map, in bf16 and f32 and at a candidate cap it overflows, every
   table and the undo record equal and two calls equal, the kept
   InsertScratch's grids all INT_MAX after each call, undo_insert
   restoring the clone exactly; timed through the kept scratch, each
   call undone outside the timing; the host us of its wrapper beside the
   earlier wrapper's table clones), K6 (recenter + active set), K5
   (reconcile + repack,
   bf16 and f32, bit-identical across three calls, two of them through
   one kept ReconcileScratch, reset after each; the host us of K4's and
   K5's wrappers beside what their earlier forms did) against their plain
   torch versions; K9a (occupancy march) and K9b (CDF placement) at the
   Adam tracker's shapes (2048 rays x 100 slots, 64 samples) and at the
   replica gate's BA superset (768 rays x 75 slots, 32 samples), K9a
   through march_occupancy and through CdfPlacer.march (the march
   launched as part of making a placer, the trackers' and BA's form),
   each with one origin per ray and with one origin expanded to every
   ray (row stride 0), cdf and n_occ torch.equal to the twin's, one
   launch a call, and the host us of a tracker frame's march + placer;
   K10a (mesh lattice) and K10b (marching tetrahedra) over every surface
   voxel (and 37 padding ids) at res 2 and res 4 with bf16 and f32
   embeddings, K10a also at B = 0 (no launch) and with the host us of its
   wrapper beside the conversions its first wrapper made, K10b padded
   against its twin and in its compact form (the
   mesh path's: only the valid triangles, compacted on the card) against
   the twin's tris[valid], T equal and the triangles torch.equal, also
   for a chunk with no triangle, twice through one kept TetScratch; K11a
   (range image) at
   one frame's 65,536 points and 64 x 1024 pixels and K11b (point-to-plane
   system) at 2048 rays; E1 (pack_embeddings and its transpose, the
   exact-gradient BA's) at kitti_exact's and the replica gate's map shapes
   (f32 tables, padding rows, a -1 corner and a corner shared by 8 voxels
   or more): the forward torch.equal to voxel_map.pack_embeddings, the
   transpose torch.equal to pack_embeddings_vjp_plain and between two
   calls through one kept PackGradScratch, beside index_select /
   index_add_; K5's sum form (reconcile_mode=sum) torch.equal to its
   twin in bf16 and f32; [ieee]: norm3 (csrc/norm3.cu, the length of
   3-vectors in XLA's CPU order) torch.equal to its plain form on the CPU
   over one frame's 65,536 points and 2048 tracker rays, beside the rows
   torch.linalg.norm gets otherwise, the routed divisions (ieee.div /
   rdiv, exp_so3's series, interp_corner_features) equal to the CPU's, the
   scan-to-scan twin's 3- and 2-vector chains and exp_so3's sine and cosine
   equal to the CPU's, and norm3 timed in turns with torch.linalg.norm;
   [trig] (csrc/trig.cu: glibc's sinf, cosf and atan2f as native/trig.h
   copies them, which lm_step.cu and scan2scan.cu include too) bit-equal
   to the host copies on every f32 of [0, pi] for sin and cos and on 10^8
   seeded atan2 pairs with the specials, its backward equal to the CPU's,
   atan2 timed beside the host copy and torch.atan2; [exp_so3]
   (csrc/exp_so3.cu, every rotation of the se3 ops on the card, one launch
   each way) torch.equal to its plain chain on the CPU forward, within 1e-5
   of each gradient's largest entry backward, in three theta^2 ranges,
   timed at BA's window beside the chain on the card; K3's dp form (the
   58 per-class sums the tracker all-reduces under dp) against
   gn_sums_plain, and combined against the one-launch form; K3's maturity
   form (tpu_specs.maturity_warmup: each sample's terms weighted by its
   row's BA-touch count, one launch) against the weighted twin, its dp form
   too;
   [ray_prep] (a ray draw's directions, t_cap, measured depth, its gate and
   lengths in one launch) torch.equal to its twin on the card and on the
   CPU at the tracker's 2048 rays and BA's superset (2 frames); [lm_step]
   (the LM update after the solve, one thread a step) on 10,000 seeded
   steps, half at small angles, against its twin on the card and on the
   CPU (batched, and one step a call): the translation and the
   small-angle half torch.equal, the rest's rotation within 4 ulp of each
   pose's largest entry and 8 of the rotation's (its sine, cosine and
   atan2 are the host's: 0-1 ulp expected), the rotation matrix it
   hands the next iteration within 8 ulp of 1 of the twin's and the twin's
   exp_so3 of the kernel's own pose, the largest gaps and the share of
   poses bit-equal printed; a GN tracker frame at 2 and
   16 iterations making the same exp_so3 and log_so3 calls and norm3
   launches (none inside the loop after its first rotation); and kernel
   A, lm_tail (csrc/lm_step.cu: a GN iteration's damping, 6 x 6 solve,
   pose step and next rays in one launch), torch.equal to lm_tail_plain on
   the card and on the CPU on 10,000 seeded systems (a grid row each) and
   at the tracker's 2048 rays, timed in turns against the parent's chain
   (damping, torch.linalg.solve_ex, lm_step, torch.matmul), whose launches
   a call are profiled beside the kernel's; [pose_rays] (kernel B,
   csrc/pose_rays.cu: a pose's origins and directions with exp_so3 folded
   in, one launch each way) at BA's current frame, window and superset and
   the Adam tracker's rays: forward torch.equal to pose_rays_plain on the
   card and on the CPU, the poses' gradient within 1e-5 of each pose's
   largest entry and bit-stable between calls, timed in turns against the
   parent's chain (exp_so3.cu, the batched product, the origins' copy,
   autograd's backward), whose launches a call are profiled too;
   [ray_draw] (kernel A: a ray draw's keys, csrc/draw_keys.cu,
   and its gathers and setup, csrc/ray_prep.cu's ray_draw, ray_superset
   and ray_pick, one launch each): the keys torch.equal to the card's
   eager chain on 2^24 uniforms, every output of the draw, the superset
   and the pick torch.equal to its twin on the card and on the CPU at the
   quality shapes (the tracker's 2048 rays of a frame's 65,536 points,
   every column and a dp rank's half; BA's superset of 2 x 2048 rays a
   frame, W = 1 and 4, its picks with a frame mask, its draw without
   one), each site timed in turns against the parent's chain; and
   [const_vel] (kernel B: the deferred warm start in one launch,
   csrc/const_vel.cu) on 10^5 seeded pose pairs in each of exp_so3's
   branches and both full settings: 0 bits differ from the CPU's
   const_vel_plain; the gap to the card's eager chain of the parent (its
   cuBLAS products) printed in ulp; timed in turns against that chain.
   K9b is checked with one origin per ray, with one origin broadcast to
   every ray (row stride 0, the trackers' form, timed at the Adam shapes)
   and over a superset cdf whose rows each call picks (BA's form, timed at
   the gate's), per call and with the placer made once per frame or step;
   it also prints the host us of its wrapper's pieces. K11b is checked
   alone and in the tracker's form (rotation given, adding into a system
   in place, which is timed; bit-identical across two calls and equal to
   one add on its sums alone).
   Prints each kernel's max error, its median time and its twin's (CUDA
   events), the least time the card could take (bound) and, for K3, K11b
   and K9b, one PyTorch call of the same function (torch.einsum pair,
   torch.searchsorted).
4. Main paths through NerfLoamSLAM_torch on the card:
   - 30 frames (process_first_frame, 29 x process_frame, finalize) of the
     KITTI-budget config (nerfloam_tpu_torch/configs/kitti_budget.json),
     of the quality stack (configs/kitti_quality.json: support voxels
     both sides, 8 band samples, bias transfer; run with a RunLogger in a
     temporary directory, so finalize writes both meshes and the pose
     files, which are read back and checked, and one mesh extract on its
     final map is split by operation: device us by name, host CPU by
     operation), of the Adam tracker at the
     KITTI budget (configs/kitti_adam25.json: 25 iterations x 2048 rays x
     64 grid samples, BA on the hit table) and of the quality stack with
     the scan-to-scan term (configs/kitti_quality_s2s.json: s2s_weight 10,
     range image 64 x 1024);
   - the replica gate (configs/replica_gate60.json: GN tracker and BA on
     the grid sampler, the quality stack, the auto touched_cap), 60
     frames for each of seeds 0 and 1, held to the JAX gate's ATE
     thresholds with growth events and no dropped deltas, and to its mesh
     thresholds (f_score, Chamfer-L1) on the cleaned mesh; each frame's
     raw translation error printed;
   - the off-by-default knobs, 30 frames each, held to the JAX package's
     ATE on the same config: configs/kitti_knobs.json (quality + replay
     every 5 frames, ba_pose_project=along, remove_back; its replay steps
     equal to JAX's, its BA-delta telemetry's along column ~0, remove_back's
     share of the points JAX's), configs/kitti_mapping_gt.json (quality on
     ground-truth poses, mapping only: no K3; its rows and mesh beside
     JAX's) and configs/kitti_decoder_pe.json (budget + a decoder skip and
     the nerf embedder, multires 4); and 10 frames of the budget config
     with the gaussian embedder, finite;
   - checkpoint and resume on the quality config: 15 frames, save, load
     into a fresh object (every saved table compared), 15 more frames and
     finalize from the loaded one;
   - the deferred schedule (tpu_specs.defer_sync, both packages' default):
     configs/kitti_quality_defer.json (30 frames with a logger, every
     kernel of the quality path launched, no overflow found with a frame
     in flight, printed beside the synchronous quality run: keyframes,
     the trajectories' difference, sdf_bias) and
     configs/kitti_budget_defer_grow.json (an active set that grows with a
     frame in flight: a deferred replay, K7 undone twice for each), each
     against the JAX package's deferred run; [defer] syncs, the
     synchronizing calls of a steady frame by site
     (torch.cuda.set_sync_debug_mode); [defer] fetch, that a finalize
     returns while a device sleep queued behind its frame still runs (it
     waits on its own staged outputs only); the checkpoint and resume
     above under defer_sync (the device pose recurrence equal after the
     load); [defer] pairs, the quality config synchronous and deferred in
     turns (sync, defer, defer, sync): scans/s, host CPU s a frame, the
     sync section's ms, host syncs a frame and, after the profiles, the
     device's busy share;
   - the reference-exact fallbacks: 30 frames of configs/kitti_exact.json
     (kitti_adam25 with exact embedding gradients through E1, BA without a
     ray superset, per-iteration tracker rays, f32 tables: E1 and K9a / K9b
     on every BA and tracker iteration, no K5, no update count) against
     the JAX package's ATE, and the replica gate (seed 0) with the three
     fallback knobs, held to the gate's limits with its raw ATE on the
     median over generator seeds 777-792 (each printed) and JAX's median
     there (the 16 draws run in four processes side by side on the card;
     the config's own seed must repeat the main path's digits).
   - the host data path and the runners over several pipelines: [loader]
     (the quality config's 30 scans written as a KITTI directory and run
     through NerfLoamSLAM_torch.run() on the port's KITTI loader, its C++
     filter and segmenter, then on a local subclass that takes the numpy
     twins, one pair: wall s, scans/s, host CPU s a frame and __getitem__ ms
     of each; the segmenter alone on a ~118k-point HDL-64 scan of the
     kitti_replica world; the C++ results equal between calls, JAX's native
     test on its own scene, masks and cosines beside the twins'; the C++
     run's ATE against the JAX package's on the same files), [subscene]
     (SubsceneRunner over the quality config's 30 frames, 10 to a submap:
     3 submaps, the chained pose6 exact, face blocks offset, the card's
     allocated bytes after each submap's del within 64 MB of the first's,
     the ATE against the JAX package's chained run) and [sequences]
     (run_sequences_parallel with two 8-frame budget jobs on the one card,
     each np.array_equal to the same job run alone), and [dp] (the quality
     config's first 10 frames on two ranks of the one card through
     parallel/sharding.run_dp, gloo by the backend rule, beside one process
     on the same seed: frame 1's tracker on the one-process run's inputs
     within 2e-4 and its hit count equal, the whole runs' frame 1 within
     2e-2 (what dp moves the JAX package's own runs), the ATE under the
     quality bound, both ranks' trajectories and
     packed tables bit-equal, each rank's launches by kernel in the kernels
     line; every frame's pose gap and the wall time printed),
     [knobs_dropped] (10 quality frames with the knobs the JAX package
     dropped: maturity_warmup 4, the keyframe bias probe, two bias
     classes: K3's maturity form on every GN iteration and its plain form
     never, every other kernel of the quality path launched, the ATE under
     max(1.5 x, + 0.05 m) of the JAX package's; then one
     do_mapping(selection_method="previous") on its keyframes) and [tp]
     (JAX's dp x tp layout, parallel/sharding.make_sharded_ba_iteration, as
     four gloo ranks spawned once on the card: the tp decoder on 65,536
     rows within 2e-5 of one process's; 5 steps over 2,048 rays on
     [knobs_dropped]'s final map and decoder, the ranks equal where JAX's
     devices are, the loss and pose within their tolerances of the same
     steps in one process, K9a, K9b, K8 and K2 launched on every rank; the
     wall time printed).
   Each path's launch counts are zeroed just before it and read just
   after; a GN path launches lm_tail once a GN iteration and lm_step
   never. Prints the
   tracker ms the s2s term adds to the quality path.
   Prints scans/s over frames 6 to the end, sections, host syncs,
   overflow counters, the final sdf_bias and the ATE against ground
   truth, and checks them: every kernel of the path launched, no drops,
   ATE in bound.
5. Each kernel-phase call profiled alone (right after the kernel phase,
   before the main paths of step 4): its device time per CUDA
   function and its CUDA launches per call (K4 in every form, K9a in
   every form, K9b, K10a at res 2 and 4, K10b in both forms, K11b, K1 in
   both origin forms, K2's d xyz form, K3 at both shapes, K8 in every
   form, lm_step, lm_tail, ray_prep, trig, exp_so3, pose_rays in
   both forms (pose_rays forward and backward: two), draw_keys, ray_draw
   in both forms, ray_superset, ray_pick and const_vel must make
   exactly one; K2's
   d packed form at most four and K7 at
   most five, all of them the port's (K7 profiled with the undo of each
   call, reported apart); K11a at most two of the port's, its other
   launches exactly those of its se3.pose_rotation, printed apart; K5's
   and K6's pack share printed). A session that misses one of a
   wrapper's CUDA functions is run again, up to sixteen sessions, and then
   the run fails. Then torch.profiler breakdowns of a few steady frames
   of the budget, quality, s2s, Adam, replica-gate, exact and deferred
   quality configs: device launches and device ms per frame (one summary
   line for all seven), device time per launch of each port kernel.
   A "[time]" line after each phase gives the seconds from the start, and
   one at the end the whole script's.

A summary line gives every path's ATE (both gate seeds raw and aligned,
the resumed run). Any failure raises (exit code 1). The last three lines
of standard output
are the kernels' JSON record, the card's name and power limit, and
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --paths kitti_budget,kitti_quality

runs only those configs' main paths (step 4; their checks too; also
replica_gate60_s<seed>, the deferred phases defer_checks and defer_pairs,
and loader, subscene, sequences, dp, knobs_dropped and tp; loader_pairs,
only there, runs the C++ and numpy-twin loaders' runs in ten pairs in turns) and prints no
result line: to compare
two trees of the port in one call, in turns, run each tree's package under
this script (copy it into the other tree's root). Each path prints its scans/s
and the host CPU seconds its process spent a frame, which a loaded host
inflates less than the wall clock.
"""

import argparse
import concurrent.futures
import gc
import hashlib
import json
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from collections import Counter
from functools import partial

import numpy as np
import torch

from nerfloam_tpu_torch import kernels
from nerfloam_tpu_torch.core import render
from nerfloam_tpu_torch.core import scan2scan as s2s
from nerfloam_tpu_torch.core import tracking as tr
from nerfloam_tpu_torch.core.frame import Frame, pose6_from_matrix_np
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
from nerfloam_tpu_torch.data import SyntheticDataset, get_dataset, ground
from nerfloam_tpu_torch.data.kitti import DataLoader as KittiLoader
from nerfloam_tpu_torch.map import mesher
from nerfloam_tpu_torch.map import voxel_map as vm
from nerfloam_tpu_torch.ops import ieee, interp, marching, raycast, se3, trig
from nerfloam_tpu_torch.native import segment_ground_native
from nerfloam_tpu_torch.ops import sampling
from nerfloam_tpu_torch.ops.sampling import draw_indices, sample_ray_indices
from nerfloam_tpu_torch.parallel import sharding, subscene
from nerfloam_tpu_torch.parallel.subscene import SubsceneRunner, run_sequences_parallel
from nerfloam_tpu_torch.utils.checkpoint import (
    DERIVED_MAP_FIELDS,
    load_checkpoint,
    save_checkpoint,
)
from nerfloam_tpu_torch.utils.config import finalize
from nerfloam_tpu_torch.utils.evaluation import ate_rmse, score_mesh
from nerfloam_tpu_torch.utils.logger import RunLogger, read_ply

# ATE (m, no alignment) of the JAX package on the same config and frame
# count, measured on a CPU from a checkout of the JAX package:
#   JAX_PLATFORMS=cpu python scripts/port_ate_reference.py [--quality | --adam25]
# (synthetic_small.yaml + bench.BENCH_OVERRIDES [+ QUALITY_OVERRIDES |
# + ADAM25_OVERRIDES and tpu_specs.track_method=adam], 30 frames,
# defer_sync off, frames fed as bench.py feeds them, then
# evaluation.ate_rmse(finalize(), gt, align=False)); kitti_adam25 run on
# 2026-10-16 (1341 s): the JAX Adam tracker diverges on this sequence at
# this learning rate, so its bound is loose; kitti_quality_s2s is
# `--quality --s2s` (tpu_specs.s2s_weight=10.0), run on 2026-10-16 (841 s)
# kitti_exact (kitti_adam25 with the reference-exact fallbacks and f32 embeddings) is
# `--adam25 --exact`, run on 2026-10-17 (960 s)
KITTI_EXACT_ATE_JAX = 1.5971614366073668
# the off-by-default knobs' paths: `--knobs`, `--mapping-gt`, `--decoder-pe`
# (kitti_knobs.json, kitti_mapping_gt.json, kitti_decoder_pe.json), run on
# 2026-10-18 (1445, 1046 and 1246 s); beside each ATE, what the JAX run
# printed that the path is held to or printed beside
KNOBS_JAX = {"ate": 1.4092449944450205, "replay_steps": 4,
             "max_abs_along_m": 6.877073627996923e-06, "remove_back_dropped": 0.07804941289772938}
MAPPING_GT_JAX = {"ate": 0.007943602417526424, "num_lat": 153702, "mesh_triangles": 357018,
                  "mesh_triangles_clean": 64810}
# the nerf-embedded decoder drifts at the budget, JAX's too
DECODER_PE_ATE_JAX = 11.336090479594267
# the deferred schedule (defer_sync, the default of both packages):
#   `--quality --defer` (kitti_quality_defer.json), run on 2026-10-18 (1084 s;
#   4 keyframes, no deferred replay), and `--defer --active-cap 16384`
#   (kitti_budget_defer_grow.json), run on 2026-10-18 (1039 s; the active set
#   grew twice, 16384 -> 32768 -> 65536, each growth found with a frame in
#   flight). Its active_cap: the card's `[main kitti_budget]` line reads
#   n_active 6,616 after the first frame and 36,942 after 30 (NVIDIA H100
#   80GB HBM3, 700 W); 16384 lies between, so the set grows mid-run.
DEFER_JAX = {"kitti_quality_defer": 1.4735098996105005,
             "kitti_budget_defer_grow": 2.0133160920374866}
ATE_JAX = {"kitti_budget": 2.0099257979398644, "kitti_quality": 1.4708145094137826,
           "kitti_adam25": 49.932506364901286, "kitti_quality_s2s": 1.4469814645550143,
           "kitti_exact": KITTI_EXACT_ATE_JAX, "kitti_knobs": KNOBS_JAX["ate"],
           "kitti_mapping_gt": MAPPING_GT_JAX["ate"], "kitti_decoder_pe": DECODER_PE_ATE_JAX,
           **DEFER_JAX}
# the host data path and the runners over several pipelines: the JAX
# package on a CPU: `--quality --kitti-dir DIR` (the quality config's scans as
# a KITTI directory, write_kitti_dir, read by JAX's kitti.DataLoader with its
# C++ path) and `--quality --subscene 10` (parallel.subscene.SubsceneRunner,
# 10 frames to a submap)
LOADER_ATE_JAX = 1.5808414038044512  # 935 s on 8 cores, 2026-10-18
SUBSCENE_ATE_JAX = 2.6745405051961355  # 1255 s on 8 cores, 2026-10-18
SUBSCENE_FRAMES = 10
SUBSCENE_MEM_SLACK = 64 << 20  # bytes allocated after each submap's del, against the first's
SEQUENCE_SEEDS = (3, 4)        # run_sequences_parallel's two budget jobs (data seeds)
SEQUENCE_FRAMES = 5  # cut from 8 to make room for [trig] and [dp]: equality needs no depth
# the C++ segmenter against its numpy twin: JAX's tolerance (tests/test_native.py:
# 41-44), and the share of ground points a cell's other plane may move past it
TWIN_MASK_AGREE = 0.9
TWIN_COS_TOL = 0.05
TWIN_COS_SHARE = 1e-3
# the along column of the BA-delta telemetry under ba_pose_project=along: BA
# projects the motion direction out of every pose update, so it reads 0 up to
# the f32 rounding of the pose (JAX pipeline.py:811-816): an ulp of a
# coordinate is 1.9-3.8e-6 m at 16-32 m, and each of BA's 25 updates rounds
# once (JAX reads 6.9e-6 m on this config)
ALONG_MAX_M = 1e-4
GAUSSIAN_FRAMES = 10  # the gaussian embedder's run on the card: finite, no bound
# replica_gate60 with the reference-exact fallbacks, seed 0: the JAX package on a CPU,
#   JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --gate60 0 --exact
# (run on 2026-10-17, 118 s; one active-set growth); printed beside the port's
GATE60_EXACT_JAX = {"raw": 0.17483422102246532, "aligned": 0.044754717005029546}
# the exact gate's generator seeds (tpu_specs.seed; 777 the config's) and JAX's raw ATE
# of the exact gate (data seed 0) at each, on a CPU:
#   JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --gate60 0 --exact --tpu-seed N
GATE60_SPREAD_SEEDS = tuple(range(777, 793))
SPREAD_WORKERS = 4  # the spread's draws side by side: each is host-bound (~1 core)
GATE60_EXACT_JAX_RAW = (
    0.17483422102246532, 0.2031743713761486, 0.22137659077424693, 0.13834254191482986,
    0.1540344387498666, 0.10957749906726641, 0.12041057388065288, 0.17778003603117476,
    0.2517731307972032, 0.20750606620938686, 0.24917867034545058, 0.19315165279646973,
    0.26302362144212466, 0.8874616253044396, 0.2411146730211767, 0.22975765344025875)
# exact paths: the gate's configs get these, kitti_exact.json has them
EXACT_OVERRIDES = {"exact_embedding_grads": True, "ba_ray_superset": 0,
                   "track_resample_rays": True}
# replica_gate60: the JAX gate's thresholds, tests/test_replica_gates.py:77-80
GATE60_ATE_RAW_MAX = 0.27
GATE60_ATE_ALIGNED_MAX = 0.17
GATE60_F_SCORE_MIN = 0.70
GATE60_CHAMFER_L1_MAX = 0.37
CKPT_FRAME = 14            # the checkpoint phase saves after this frame
GATE60_SEEDS = (0, 1)
WARMUP_FRAMES = 6
TIMED_RUNS = 20
PAIRED_RUNS = 200          # K9b and K11b against their library calls, in turns
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12         # H100 SXM, float32 outside the tensor cores
# Host sleep at each edge of a profiled window. The trace's device
# timestamps stray from the host clock (by up to ~7 ms on one machine,
# scripts/profiler_sessions.py; on others 25 ms pads still lost the first or
# last records of a window, up to 5 sessions in a row), and kineto drops the
# records that fall outside the window.
PROFILE_PAD_S = 0.1
# [dp]: the quality config on two ranks of one card (gloo, parallel/sharding.run_dp)
# beside one process, over DP_FRAMES frames; frame 1's tracked pose within JAX's
# dp tolerance of the one-process run's (tests/test_sharding.py:253-256)
DP_RANKS = 2
DP_FRAMES = 10
DP_POSE_TOL = 2e-4
# ... and in the whole runs, whose frame 0 BA is split too, frame 1's tracked
# pose within this many m (or rad) of one process's: the JAX package's own dp=4
# run moves its first 6 tracked poses up to 2.12e-2 from its dp=1 run's (1.89e-3
# at frame 1) on synthetic_small, scripts/dp_gap_witness.py on a CPU
DP_RUN_TOL = 2e-2
# [trig]: seeded atan2 pairs of the device copies against the host copies, in
# chunks of TRIG_CHUNK (every float of [0, pi] for sin and cos goes the same way)
# [knobs_dropped]: the knobs the JAX package measured and dropped, on the
# quality config's first frames; JAX's ATE on the CPU for the same config
# and frames: scripts/port_ate_reference.py --dropped
MATURITY_WARMUP = 4
KNOBS_DROPPED = {"maturity_warmup": MATURITY_WARMUP, "bias_source": "keyframe",
                 "bias_classes": 2}
KNOBS_DROPPED_FRAMES = 10
KNOBS_DROPPED_ATE_JAX = 0.031597230851823796  # 644 s on 8 cores, 2026-10-18
# [tp]: JAX's dp x tp layout (parallel/sharding.make_sharded_ba_iteration) as
# TP_RANKS gloo ranks on the one card, on [knobs_dropped]'s final map and decoder
TP_RANKS = 4               # dp = 2 x tp = 2, make_mesh's rule
TP_ROWS = 65536            # feature rows of the tp decoder check
TP_DEC_TOL = 2e-5          # tests/test_sharding.py::test_tp_decoder_matches_single_device
TP_RAYS = 2048             # 1024 a dp rank
TP_STEPS = 5
# JAX's own tp mesh against one device (scripts: tests/test_torch_tp.py's
# problem, 5 steps on the CPU): its pose within 2 lr a step (Adam moves a
# component by about lr a step, and the tp ranks' pose gradients are each
# their own column block's share) and its loss within 10% (each dp rank's
# loss takes its own counts); held here to 2 x TP_STEPS x lr_pose and 15%
TP_LOSS_RTOL = 0.15
TRIG_PAIRS = 10 ** 8
# [exp_so3]: the backward's largest gap to autograd of the plain chain, relative
# to each gradient's largest entry (the sums of a reduction run in another order)
EXP_SO3_GRAD_TOL = 1e-5
TRIG_CHUNK = 1 << 26
_MAP = ("insert", "reconcile", "active_set")
# every pose's rays (se3.pose_rays: BA, the Adam tracker, the GN tracker's first
# rotation) one launch of csrc/pose_rays.cu each way, and the other rotations
# (se3.exp_so3: the map's insert on every path) one of csrc/exp_so3.cu each way
_ROT = ("exp_so3", "pose_rays")
# a ray draw: its keys in one launch (draw_keys), then the trackers' and the
# superset-less BA's gathers and setup in one (ray_draw), BA's superset in one
# (ray_superset) and each of its iterations' picks in one (ray_pick)
_DRAW = ("draw_keys", "ray_draw")
_SUPERSET = ("draw_keys", "ray_superset", "ray_pick")
_RAYS = _DRAW + _SUPERSET[1:] + _ROT
# the norm's own launch is left to the cold sites (ops/ieee.py): the bias probe
# and the support directions of the quality stack
_NORM = ("norm3",)
_GN = ("gn_system", "lm_tail")  # a GN iteration's normal equations and its tail
_MESH = ("mesh_lattice", "marching_tets")
_QUALITY = ("hit_table", "hits_field_fwd", "hits_field_bwd", "active_field_fwd") + _GN
PATH_KERNELS = {           # kernels each main path must launch
    "kitti_budget": ("hit_table", "hits_field_fwd", "hits_field_bwd") + _GN + _MAP + _RAYS,
    "kitti_quality": _QUALITY + _MAP + _MESH + _RAYS + _NORM,
    "kitti_quality_s2s": _QUALITY + _MAP + ("build_prev_scan", "s2s_system") + _RAYS + _NORM,
    "kitti_adam25": ("march_occupancy", "place_samples_cdf", "active_field_fwd",
                     "hits_field_bwd", "hit_table", "hits_field_fwd") + _MAP + _RAYS,
    "replica_gate60": ("march_occupancy", "place_samples_cdf", "active_field_fwd",
                       "hits_field_bwd") + _GN + _MAP + _MESH + _RAYS + _NORM,
    # exact gradients: E1 every BA iteration, no reconcile (no voxel touched);
    # BA without a superset: a fresh draw (ray_draw) every iteration
    "kitti_exact": ("march_occupancy", "place_samples_cdf", "active_field_fwd", "hits_field_bwd",
                    "pack_embeddings", "pack_embeddings_vjp", "insert", "active_set")
    + _DRAW + _ROT,
    "replica_gate60_exact": ("march_occupancy", "place_samples_cdf", "active_field_fwd",
                             "hits_field_bwd", "pack_embeddings", "pack_embeddings_vjp", "insert",
                             "active_set") + _GN + _MESH + _DRAW + _ROT + _NORM,
    # the off-by-default knobs: replay, along, remove_back on the quality stack
    "kitti_knobs": _QUALITY + _MAP + _MESH + _RAYS + _NORM,
    # mapping only on GT poses: BA (K4, K1, K2, K8) and the map, no tracker (no
    # K3, no tracker draw)
    "kitti_mapping_gt": ("hit_table", "hits_field_fwd", "hits_field_bwd", "active_field_fwd")
    + _MAP + _MESH + _SUPERSET + _ROT + _NORM,
    # a decoder skip and the nerf embedder on the budget row
    "kitti_decoder_pe": ("hit_table", "hits_field_fwd", "hits_field_bwd") + _GN + _MAP + _RAYS,
}
# the loader's run has no logger (no mesh); the subscene runner meshes each
# submap; the sequences jobs mesh the budget config
PATH_KERNELS["loader"] = _QUALITY + _MAP + _RAYS + _NORM
# the dropped knobs on the quality stack, no logger: K3 in its maturity form
PATH_KERNELS["knobs_dropped"] = tuple(k for k in PATH_KERNELS["loader"] if k != "gn_system") + (
    "gn_system_maturity",)
# the deferred schedule runs the same kernels as its synchronous config, and its
# warm start on the device in one launch (const_vel); the budget run whose
# active set grows with a frame in flight also undoes K7
PATH_KERNELS["kitti_quality_defer"] = PATH_KERNELS["kitti_quality"] + ("const_vel",)
PATH_KERNELS["kitti_budget_defer_grow"] = PATH_KERNELS["kitti_budget"] + ("undo_insert",
                                                                          "const_vel")
DEFER_PATHS = ("kitti_quality_defer", "kitti_budget_defer_grow")
# paths run with a RunLogger: finalize writes both meshes and the pose files
LOGGED = ("kitti_quality", "kitti_knobs", "kitti_mapping_gt", "kitti_quality_defer")
DEFER_SLEEP_MS = 50  # the [defer] fetch check's device sleep behind a finalize
# the CUDA functions behind each wrapper (csrc/*.cu), for the profile
KERNEL_FUNCTIONS = {
    "hit_table": ("hit_table_warp_kernel",),
    "hits_field_fwd": ("hits_field_fwd_kernel",),
    "hits_field_bwd": ("hits_field_bwd_kernel", "hits_field_scan_kernel",
                       "hits_field_scatter_kernel", "hits_field_reduce_kernel"),
    "active_field_fwd": ("active_field_fwd_kernel",),
    "gn_system": ("gn_system_kernel",),
    "insert": ("insert_elect_kernel", "insert_candidate_kernel", "insert_alloc_kernel",
               "insert_activate_kernel", "insert_pack_kernel"),
    "undo_insert": ("insert_undo_kernel",),
    "active_set": ("grid_fill_kernel", "recenter_kernel", "refresh_mark_kernel",
                   "refresh_place_kernel", "active_pack_rows_kernel"),
    "reconcile": ("reconcile_scan_kernel", "reconcile_link_kernel", "reconcile_fold_kernel",
                  "active_pack_rows_kernel"),
    "march_occupancy": ("march_occupancy_kernel",),
    "place_samples_cdf": ("place_samples_kernel",),
    "mesh_lattice": ("mesh_lattice_kernel",),
    "marching_tets": ("marching_tets_kernel",),
    "build_prev_scan": ("s2s_range_image_kernel",),
    "s2s_system": ("s2s_system_kernel",),
    "pack_embeddings": ("active_pack_rows_kernel",),
    "pack_embeddings_vjp": ("pack_grad_kernel",),
    "pack_embeddings_vjp_build": ("pack_grad_link_kernel", "pack_grad_order_kernel"),
    "norm3": ("norm3_kernel",),
    "lm_step": ("lm_step_kernel",),
    "lm_tail": ("lm_tail_kernel",),
    "ray_prep": ("ray_prep_kernel",),
    "draw_keys": ("draw_keys_kernel",),
    "ray_draw": ("ray_draw_kernel",),
    "ray_superset": ("ray_superset_kernel",),
    "ray_pick": ("ray_pick_kernel",),
    "const_vel": ("const_vel_kernel",),
    "trig": ("trig_fwd_kernel",),
    "trig_bwd": ("trig_bwd_kernel",),  # its backward, a form of the trig record
    "exp_so3": ("exp_so3_fwd_kernel",),
    "exp_so3_bwd": ("exp_so3_bwd_kernel",),  # its backward, a form of the exp_so3 record
    "pose_rays": ("pose_rays_fwd_kernel",),
    "pose_rays_bwd": ("pose_rays_bwd_kernel",),  # its backward, a form of the pose_rays record
    "gn_sums": ("gn_system_kernel",),  # K3's dp form: the same kernel, its sums written
    "gn_system_maturity": ("gn_system_kernel",),  # K3's maturity form: the same kernel
}
# wrappers (and forms of one) that launch one kernel and no torch op
ONE_LAUNCH = ("hit_table", "hit_table, origin row stride 0",
              "hit_table, packed, origin row stride 0", "hit_table, R=2048, origin row stride 0",
              "place_samples_cdf", "s2s_system", "hits_field_fwd",
              "hits_field_fwd, origin row stride 0", "hits_field_bwd, d xyz", "gn_system",
              "gn_system, gate", "active_field_fwd", "active_field_fwd, band, origin row stride 0",
              "active_field_fwd, probe", "active_field_fwd, gate grid columns, origin row stride 0",
              "active_field_fwd, gate band, origin row stride 0", "march_occupancy",
              "mesh_lattice", "mesh_lattice, res 4", "marching_tets", "marching_tets, padded",
              "pack_embeddings", "pack_embeddings_vjp", "pack_embeddings, gate60",
              "pack_embeddings_vjp, gate60", "norm3", "norm3, R=2048", "lm_step", "ray_prep",
              "ray_prep, BA superset", "trig", "trig, atan2 backward", "gn_sums",
              "gn_system_maturity", "exp_so3",
              "exp_so3, backward", "lm_tail", "lm_tail, 10,000 systems", "pose_rays",
              "pose_rays, backward", "pose_rays, Adam tracker", "draw_keys", "ray_draw",
              "ray_draw, BA without a superset, window of 4", "ray_superset", "ray_pick",
              "const_vel") + tuple(
    f"{form}, {shape}" for shape in ("adam25", "gate60")
    for form in ("march_occupancy, origin row stride 0", "CdfPlacer.march",
                 "CdfPlacer.march, origin row stride 0"))
# at most this many CUDA launches a call, all the port's: K2's d-packed form, K7
MAX_LAUNCHES = {"hits_field_bwd": 4, "insert": 5}
# at most this many of the port's a call, the others only those of the rotation it builds
# (se3.pose_rotation): K11a
MAX_PORT_LAUNCHES = {"build_prev_scan": 2}
# a kernel-phase call that undoes what it wrote, so that it can be repeated: the
# undo's CUDA function, profiled with it and reported apart
UNDONE_BY = {"insert": "insert_undo_kernel"}


def ate_bound(name):
    a = ATE_JAX[name]
    return max(1.5 * a, a + 0.05)


def load_cfg(here, name, seed=None, exact=False, tpu_seed=None, **groups):
    """A config of nerfloam_tpu_torch/configs/ with the data seed, the
    generator seed, the exact fallbacks and ``groups`` ({group: {key:
    value}}) set."""
    with open(os.path.join(here, "nerfloam_tpu_torch", "configs", f"{name}.json")) as f:
        d = json.load(f)
    for group, values in groups.items():
        d[group].update(values)
    if seed is not None:
        d["data_specs"]["seed"] = seed
    if tpu_seed is not None:
        d["tpu_specs"]["seed"] = tpu_seed
    if exact:
        d["tpu_specs"].update(EXACT_OVERRIDES)
    return finalize(d)


def log(*a):
    print(*a, flush=True)


def median_ms(fn, n=TIMED_RUNS):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def paired_median_ms(fn_a, fn_b, n=PAIRED_RUNS):
    """Median ms of fn_a and of fn_b (CUDA events around one call), the two
    timed in turns so that both see the same host: a kernel's wrapper
    against the one PyTorch call that computes the same function."""
    ta, tb = [], []
    for fn in (fn_a, fn_b):
        fn()
    torch.cuda.synchronize()
    for _ in range(n):
        for fn, times in ((fn_a, ta), (fn_b, tb)):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
    return float(np.median(ta)), float(np.median(tb))


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def running_sum(seg):
    """(R, H) inclusive sums of seg's columns, one f32 add at a time in
    ascending column order (K4's cdf, bit for bit)."""
    acc, cols = torch.zeros_like(seg[:, 0]), []
    for h in range(seg.shape[1]):
        acc = acc + seg[:, h]
        cols.append(acc)
    return torch.stack(cols, 1)


def bound(nbytes, flops):
    """Least time (ms) for the work: bytes over the HBM rate or f32 flops
    over the f32 rate, the larger of the two, and which one it is."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


_COUNTERS = {  # wrapper name -> (module, launch counter)
    "hit_table": (raycast, "hit_table_launches"),
    "hits_field_fwd": (render, "hits_field_fwd_launches"),
    "hits_field_bwd": (render, "hits_field_bwd_launches"),
    "active_field_fwd": (render, "active_field_fwd_launches"),
    "gn_system": (tr, "gn_system_launches"),
    "insert": (vm, "insert_launches"),
    "undo_insert": (vm, "insert_undo_launches"),
    "active_set": (vm, "active_set_launches"),
    "reconcile": (vm, "reconcile_launches"),
    "march_occupancy": (raycast, "march_occupancy_launches"),
    "place_samples_cdf": (raycast, "place_samples_cdf_launches"),
    "mesh_lattice": (mesher, "mesh_lattice_launches"),
    "marching_tets": (marching, "marching_tets_launches"),
    "build_prev_scan": (s2s, "build_prev_scan_launches"),
    "s2s_system": (s2s, "s2s_system_launches"),
    "pack_embeddings": (vm, "pack_embeddings_launches"),
    "pack_embeddings_vjp": (vm, "pack_grad_launches"),
    "pack_embeddings_vjp_build": (vm, "pack_grad_build_launches"),
    "norm3": (ieee, "norm3_launches"),
    "lm_step": (tr, "lm_step_launches"),
    "lm_tail": (tr, "lm_tail_launches"),
    "ray_prep": (tr, "ray_prep_launches"),
    "draw_keys": (sampling, "draw_keys_launches"),
    "ray_draw": (tr, "ray_draw_launches"),
    "ray_superset": (tr, "ray_superset_launches"),
    "ray_pick": (tr, "ray_pick_launches"),
    "const_vel": (se3, "const_vel_launches"),
    "trig": (trig, "trig_launches"),
    "exp_so3": (se3, "exp_so3_launches"),
    "pose_rays": (se3, "pose_rays_launches"),
    "gn_sums": (tr, "gn_sums_launches"),
    "gn_system_maturity": (tr, "gn_maturity_launches"),
}


def counters():
    return {k: getattr(mod, attr) for k, (mod, attr) in _COUNTERS.items()}


def zero_counters():
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


def port_kernel_times(averages):
    """{CUDA function of csrc/*.cu: (device us in all, launches)} from a
    torch.profiler run's ``key_averages()``."""
    ours = {fn for fns in KERNEL_FUNCTIONS.values() for fn in fns}
    out = {}
    for e in averages:
        m = re.search(r"\(anonymous namespace\)::(\w+)", e.key)
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if m is None or m.group(1) not in ours or not e.count or not dev_us:
            continue
        t, n = out.get(m.group(1), (0.0, 0))
        out[m.group(1)] = (t + dev_us, n + e.count)
    return out


def device_us(name, fn, reps=20, sessions=16, want=None):
    """Device microseconds per launch of each CUDA function a wrapper call
    launches, averaged over the launches torch.profiler captured in
    ``reps`` calls, their sum (the device time of one call, each function
    launching once per call), and the device launches (the port's
    kernels, torch's, copies) per call. Each session traces a warm-up step of
    ``reps`` calls that it discards (a cold session drops kernel records)
    before the ``reps`` it keeps, each step's calls between two sleeps of
    PROFILE_PAD_S. Every function of KERNEL_FUNCTIONS[name]
    (or of ``want``, a form's own functions) must show ``reps`` launches at
    least, and every device operation that recurs a whole multiple of
    ``reps``: a session that drops records, or keeps a stray few of the
    discarded step's, is run again, and after ``sessions`` such sessions
    the run fails."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    want = KERNEL_FUNCTIONS[name] if want is None else want
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     acc_events=True) as prof:
            for _ in range(2):
                time.sleep(PROFILE_PAD_S)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                time.sleep(PROFILE_PAD_S)
                prof.step()
        averages = prof.key_averages()
        times = port_kernel_times(averages)
        # device work that recurs on every call (a session also holds a
        # stray record or two of the profiler's own; an operation with
        # half its records or more is counted, so that one which lost some
        # fails the whole-multiple test)
        recurring = [e.count for e in averages
                     if _on_device(e) and e.count >= reps // 2]
        if all(times.get(f, (0, 0))[1] >= reps for f in want) and not any(
                n % reps for n in recurring):
            per_fn = {k: t / n for k, (t, n) in times.items()}
            return per_fn, sum(per_fn.values()), sum(recurring) / reps
        log(f"[{name}] the profiler kept {({f: times.get(f, (0, 0))[1] for f in want})} "
            f"launches of {reps} calls, device operations recurring {recurring} times; "
            "profiling again")
    raise AssertionError(f"{name}: the profiler dropped or added launches of {want} in "
                         f"{sessions} sessions")


def _on_device(e):
    return getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)


def record(name, source, replaces, err, k_ms, p_ms, nbytes, flops, library_ms=None, dev=None,
           forms=None, **extra):
    """One kernel's JSON record. ``dev`` is a call of the wrapper on the
    same inputs: its device time is profiled once every record is made
    (``add_device_times``), right after the kernel phase and before the
    main paths: after the main paths and the runners, torch.profiler's
    scheduled sessions kept 7 of 20 kernel records in 44-58% of sessions,
    in runs of 16 and more (on an H100), and none right after the kernel
    phase; so are ``forms``, {label: (call, its CUDA functions)}, other forms of
    the wrapper whose launches are checked (ONE_LAUNCH) and printed."""
    b_ms, b_by = bound(nbytes, flops)
    log(f"[{name}] kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
        f"{nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP)"
        + ("" if library_ms is None else f", library {library_ms:.4f} ms"))
    return {"name": name, "route": "cuda", "source": f"nerfloam_tpu_torch/csrc/{source}",
            "replaces": replaces, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms, "_dev": dev,
            "_forms": forms or {}, **extra}


def add_device_times(records):
    """Device microseconds per call and per launch of every kernel, from
    torch.profiler over its kernel-phase call."""
    for r in records:
        undo = UNDONE_BY.get(r["name"])
        dev_fn = r.pop("_dev")
        # K11a's call builds its rotation: one exp_so3 launch, wanted too
        want = (KERNEL_FUNCTIONS[r["name"]] + ((undo,) if undo else ())
                + (KERNEL_FUNCTIONS["exp_so3"] if r["name"] in MAX_PORT_LAUNCHES else ()))
        per_fn, per_call, launches = device_us(r["name"], dev_fn, want=want)
        if undo is not None:  # the profiled call undoes its insert: the undo apart
            r["undo_device_us"] = per_fn.pop(undo)
            per_call -= r["undo_device_us"]
            launches -= 1
            log(f"[{r['name']}] its undo ({undo}): {r['undo_device_us']:.2f} us per call, 1 "
                "CUDA launch (profiled with each call, taken out of the numbers below)")
        r["device_us_per_call"], r["device_us"], r["device_launches_per_call"] = (
            per_call, per_fn, launches)
        log(f"[{r['name']}] device us per launch: "
            + ", ".join(f"{k} {v:.2f}" for k, v in per_fn.items())
            + f"; {per_call:.2f} us per call; {launches:g} CUDA launches per call (profile)")
        if r["name"] in MAX_PORT_LAUNCHES:  # the others: the rotation the wrapper builds
            rotation = r.pop("_rotation")
            # its own kernels' launches; the others (csrc/exp_so3.cu's) are the
            # rotation's
            own = lambda fns: sum(1 for f in fns if f in KERNEL_FUNCTIONS[r["name"]])
            for _ in range(3):  # a session that lost a whole operation's records: again
                # the rotation is one exp_so3 launch: wanted, so that a session
                # that dropped its records is run again
                _, _, rot = device_us(r["name"], rotation, want=KERNEL_FUNCTIONS["exp_so3"])
                if launches - own(per_fn) == rot:
                    break
                log(f"[{r['name']}] {launches:g} launches a call, {own(per_fn)} of them its "
                    f"own, against {rot:g} of the rotation alone; profiling both again")
                per_fn, per_call, launches = device_us(r["name"], dev_fn, want=want)
            port = own(per_fn)
            r["device_launches_port"], r["device_launches_rotation"] = port, launches - port
            log(f"[{r['name']}] {launches:g} CUDA launches per call: {port} its own, "
                f"{launches - port:g} of its rotation (se3.pose_rotation alone: {rot:g})")
            check(port <= MAX_PORT_LAUNCHES[r["name"]] and launches - port == rot,
                  f"{r['name']}: {port} of its own launches a call (at most "
                  f"{MAX_PORT_LAUNCHES[r['name']]}) and {launches - port:g} others, where the "
                  f"rotation alone makes {rot:g}")
        if r["name"] in ONE_LAUNCH:
            check(launches == 1, f"{r['name']}: {launches} CUDA launches per call, not one")
        pack = per_fn.get("active_pack_rows_kernel")
        if pack is not None:  # K5's and K6's shared pack pass
            log(f"[{r['name']}] the pack pass: {pack:.2f} of {per_call:.2f} us per call "
                f"({pack / per_call:.3f})")
        if r["name"] in MAX_LAUNCHES:
            check(launches <= MAX_LAUNCHES[r["name"]] and launches == len(per_fn),
                  f"{r['name']}: {launches} CUDA launches per call, {len(per_fn)} of them the "
                  f"port's; at most {MAX_LAUNCHES[r['name']]}, all the port's")
        for label, (fn, want) in r.pop("_forms").items():
            f_fn, f_call, f_launches = device_us(r["name"], fn, want=want)
            r.setdefault("forms", {})[label] = {"device_us_per_call": f_call,
                                                "device_launches_per_call": f_launches}
            log(f"[{label}] device us per launch: "
                + ", ".join(f"{k} {v:.2f}" for k, v in f_fn.items())
                + f"; {f_call:.2f} us per call; {f_launches:g} CUDA launches per call (profile)")
            if label in ONE_LAUNCH:
                check(f_launches == 1, f"{label}: {f_launches} CUDA launches per call, not one")
            if label.endswith("forward and backward"):  # one launch each way, no torch op
                check(f_launches == 2, f"{label}: {f_launches} CUDA launches per call, not two")


def rows_read(aid, valid):
    """Distinct packed rows the valid samples need (512 B each)."""
    return int(torch.unique(aid[valid]).numel())


def samples_per_row(aid, valid, n_rows):
    """The packed rows K2's d packed form touches and the valid samples
    each receives: count, mean, p50, p99, max."""
    c = torch.bincount(aid[valid].long(), minlength=n_rows)
    c = c[c > 0].float()
    if not len(c):
        return "no touched row"
    return (f"{len(c)} touched rows of {n_rows}, mean {float(c.mean()):.2f}, p50 "
            f"{float(c.quantile(0.5)):g}, p99 {float(c.quantile(0.99)):g}, max {int(c.max())}")


def kernel_phase(slam, ds, rc_gate, gate_track, loops, sp, e1_shapes):
    """Every kernel against its plain version: K4, K1, K2, K8, K3, K7, K6,
    K5, K10a and K10b at the quality shapes, K8 and K3 also at the replica
    gate tracker's (``gate_track``: its rays and samples), K9a and K9b at
    the Adam tracker's and the replica gate's BA superset shapes
    (``rc_gate``; ``loops``: the Adam tracker's iterations a frame and the
    gate's BA iterations a step), K11a and K11b at the s2s config's image
    (``sp``, its Scan2ScanParams), E1 at the exact-gradient paths' map
    shapes (``e1_shapes``: {label: (capacity, active cap)})."""
    dev = slam.device
    cfg, rc_t, rc_m = slam.map_cfg, slam.rc_track, slam.rc_map
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    frames = []
    for i in range(4):
        idx, pts, cos, _ = ds[i]
        frames.append(Frame.from_raw(idx, pts, cos, ds.get_init_pose(i), slam.points_pad))
    ms = vm.create(cfg, dev)
    ms = vm.recenter(ms, cfg, torch.as_tensor(frames[0].pose6[:3], device=dev))
    for f in frames[:3]:
        p, c, v = f.device_arrays(dev)
        ms, _ = vm.insert_frame(ms, cfg, p, c, v, torch.as_tensor(f.pose6, device=dev),
                                slam.insert_cand_cap)
    emb = (torch.randn(ms.embeddings.shape, generator=gen, device=dev) * 0.1)
    ms = vm.refresh_active(ms._replace(embeddings=emb.to(ms.embeddings.dtype)), cfg)
    log(f"[kernels] map: {int(ms.num_lat)} lattice rows, {int(ms.n_active)} active voxels "
        f"(A={ms.packed.shape[0]}), grid {cfg.grid_dim}, support {cfg.support_dist} m "
        f"sym {cfg.support_sym}")

    p, c, v = frames[0].device_arrays(dev)
    pose = torch.as_tensor(pose6_from_matrix_np(ds.get_init_pose(0)), device=dev)

    def rays(n):
        idx, rvalid = sample_ray_indices(v, n, gen)
        pts, pcos = p[idx], c[idx]
        rp = tr.ray_prep(pts, pcos, 0.3, rc_t.max_depth)
        d = se3.rotate_dirs(pose, rp.dirs)
        o = se3.pose_translation(pose).expand_as(d).contiguous()
        return o, d.contiguous(), rp.t_cap, pts, pcos, rvalid

    records = []

    # ---- K4 at the tracker (R=2048) and BA superset (R=4096) shapes, each
    # with one origin per ray, with one origin expanded to every ray (row
    # stride 0: the tracker's and a one-frame BA step's form, read as it
    # is) and in BA's packed form
    e4 = 0.0  # cdf against the twin's torch.cumsum
    tables, k4_calls = {}, {}
    cstep, S = raycast._coarse_shape(rc_t)
    H = rc_t.max_hits
    for R in (slam.tp.n_rays, 2 * slam.bp_current.n_rays):
        o, d, tc, pts, pcos, rvalid = rays(R)
        o1 = o[:1].expand_as(d)
        ref = raycast.build_hit_table_plain(ms, cfg, rc_t, o, d, tc)
        for form, ro in (("origin per ray", o), ("origin row stride 0", o1)):
            ker = raycast.build_hit_table(ms, cfg, rc_t, ro, d, tc)
            kp = raycast.build_hit_table_packed(ms, cfg, rc_t, ro, d, tc)
            torch.cuda.synchronize()
            for nm in ("aid", "cell", "ray_mask", "t_near", "seg"):
                check(torch.equal(getattr(ker, nm), getattr(ref, nm)), f"K4 {nm} differs (R={R}, "
                      f"{form})")
            check(torch.equal(ker.cdf, running_sum(ref.seg)),
                  f"K4 cdf is not the running f32 sum of seg (R={R}, {form})")
            check(torch.equal(kp, raycast.pack_hit_table(ker)),
                  f"K4's packed rows are not pack_hit_table of its table (R={R}, {form})")
            e4 = max(e4, max_abs(ker.cdf, ref.cdf))
            k4_calls[R, form] = partial(raycast.build_hit_table, ms, cfg, rc_t, ro, d, tc)
        k4_calls[R, "packed, origin row stride 0"] = partial(raycast.build_hit_table_packed, ms,
                                                             cfg, rc_t, o1, d, tc)
        tables[R] = (o, d, tc, ref, pts, pcos, rvalid)
        hits = float((ref.aid >= 0).sum(1).float().mean())
        log(f"[K4] R={R}: mean hits/ray {hits:.2f}, ray hit rate "
            f"{float(ref.ray_mask.float().mean()):.3f}; aid, cell, ray_mask, t_near, seg equal to "
            "the twin, cdf to the running f32 sum of its seg, packed rows to pack_hit_table, with "
            "one origin per ray and with one origin expanded (row stride 0)")
    k4_bound = {}
    for R in tables:
        tc = tables[R][2]
        # probes the rays need: each walks to its range (t_cap + one step);
        # the rays (an origin each, or one), the probes' grid cells and the
        # table's 28 bytes a slot (+ ray_mask unpacked) moved
        probes = float(torch.clamp(torch.ceil((tc + cstep) / cstep), max=S).sum())
        out = R * H * 28
        k4_bound[R, "origin per ray"] = (R * 28 + 4 * probes + out + R, 12 * probes + 20 * R * H)
        k4_bound[R, "origin row stride 0"] = (12 + R * 16 + 4 * probes + out + R,
                                              12 * probes + 20 * R * H)
        k4_bound[R, "packed, origin row stride 0"] = (12 + R * 16 + 4 * probes + out,
                                                      12 * probes + 20 * R * H)
        log(f"[K4] R={R} S={S} H={H}: {probes / R:.1f} probes per ray")
    for (R, form), call in k4_calls.items():
        log(f"[K4] R={R}, {form}: kernel {median_ms(call):.4f} ms, bound "
            f"{bound(*k4_bound[R, form])[0]:.5f} ms")
    R = 2 * slam.bp_current.n_rays
    o, d, tc = tables[R][:3]
    p_ms = median_ms(lambda: raycast.build_hit_table_plain(ms, cfg, rc_t, o, d, tc))
    k4_forms = {"hit_table, origin row stride 0": k4_calls[R, "origin row stride 0"],
                "hit_table, packed, origin row stride 0": k4_calls[R, "packed, origin row stride 0"],
                "hit_table, R=2048, origin row stride 0":
                    k4_calls[slam.tp.n_rays, "origin row stride 0"]}
    records.append(record("hit_table", "hit_table.cu", "nerfloam_tpu/ops/raycast.py:159", e4,
                          median_ms(k4_calls[R, "origin per ray"]), p_ms,
                          *k4_bound[R, "origin per ray"], dev=k4_calls[R, "origin per ray"],
                          forms={k: (v, KERNEL_FUNCTIONS["hit_table"])
                                 for k, v in k4_forms.items()}))

    # ---- K1 / K2 at the tracker (M=64, one origin expanded to every ray,
    # row stride 0, as the trackers pass it) and BA (M=48, one origin per
    # ray) shapes, with the origin moved 1 cm off the table's so samples
    # re-resolve
    e1 = e2p = 0.0
    times, forms, host_args = {}, {}, {}
    for name, R, M in (("track", slam.tp.n_rays, rc_t.n_samples),
                       ("ba", slam.bp_current.n_rays, rc_m.n_samples)):
        o, d, tc, ht, *_ = tables[slam.tp.n_rays] if name == "track" else tables[2 * R]
        ht = raycast.HitTable(*[x[:R].contiguous() for x in ht])
        o = (o[:1] + 0.01).expand(R, 3) if name == "track" else (o[:R] + 0.01).contiguous()
        d = d[:R].contiguous()
        u = raycast.uniform_jitter((R, M), gen, dev)
        ker = render.hits_field_fwd(ht, u, o, d, ms.packed, cfg.voxel_size)
        ref = render.hits_field_fwd_plain(ht, u, o, d, ms.packed, cfg.voxel_size)
        torch.cuda.synchronize()
        for i, nm in enumerate(("z", "valid", "aid", "xyz")):
            check(torch.equal(ker[i], ref[i]), f"K1 {nm} differs ({name})")
        ef = max_abs(ker[4], ref[4])
        check(ef <= 1e-6, f"K1 feats error {ef} ({name})")
        e1 = max(e1, ef)
        valid, aid, xyz = ref[1], ref[2], ref[3]
        dfeats = torch.randn((R, M, 16), generator=gen, device=dev)
        k2s = render.DpackedScratch()  # kept over the calls, as a BA step keeps it
        kx, kp = render.hits_field_bwd(dfeats, xyz, aid, valid, ms.packed, cfg.voxel_size,
                                       scratch=k2s)
        rx, rp = render.hits_field_bwd_plain(dfeats, xyz, aid, valid, ms.packed,
                                             cfg.voxel_size, True)
        torch.cuda.synchronize()
        kx2, kp2 = render.hits_field_bwd(dfeats, xyz, aid, valid, ms.packed, cfg.voxel_size,
                                         scratch=k2s)
        check(torch.equal(kx, kx2) and torch.equal(kp, kp2), f"K2 differs between two calls ({name})")
        ex = max_abs(kx, rx) / max(float(rx.abs().max()), 1e-30)
        ep = max_abs(kp, rp)
        check(ex <= 1e-5, f"K2 d xyz rel error {ex} ({name})")
        check(ep <= 1e-5 * float(rp.abs().max()), f"K2 d packed error {ep} ({name})")
        check(torch.equal(kp, render.dpacked_in_row_order_plain(dfeats, xyz, aid, valid, len(kp),
                                                                cfg.voxel_size)),
              f"K2 d packed differs from its row-order oracle ({name})")
        gx, none = render.hits_field_bwd(dfeats, xyz, aid, valid, ms.packed, cfg.voxel_size,
                                         want_dpacked=False)
        check(none is None and torch.equal(gx, kx), f"K2's d xyz form differs ({name})")
        e2p = max(e2p, ep)
        nv, nrows = int(valid.sum()), rows_read(aid, valid)
        log(f"[K1/K2] {name} R={R} M={M}: valid {float(valid.float().mean()):.3f}, "
            f"feats err {ef:.3g}, dxyz rel err {ex:.3g}, dpacked err {ep:.3g} "
            f"(max |dpacked| {float(rp.abs().max()):.3g}, rows {kp.shape[0]}, "
            f"distinct rows read {nrows}); d packed equal to dpacked_in_row_order_plain")
        log(f"[K2] {name}: samples per touched row {samples_per_row(aid, valid, len(kp))}")
        times[name] = (
            median_ms(lambda: render.hits_field_fwd(ht, u, o, d, ms.packed, cfg.voxel_size)),
            median_ms(lambda: render.hits_field_fwd_plain(ht, u, o, d, ms.packed,
                                                          cfg.voxel_size)),
            median_ms(lambda: render.hits_field_bwd(dfeats, xyz, aid, valid, ms.packed,
                                                    cfg.voxel_size, scratch=k2s)),
            median_ms(lambda: render.hits_field_bwd_plain(dfeats, xyz, aid, valid, ms.packed,
                                                          cfg.voxel_size, True)),
            # fwd: hit table (aid, t_near, seg, cdf, 3 cell ints: 28 B a slot) +
            # jitter + rays + rows in, z/valid/aid/xyz/feats out
            R * H * 28 + R * M * 4 + R * 24 + 512 * nrows + R * M * 85, 300 * nv + 40 * R * M,
            # bwd: valid + aid of every sample, dfeats + xyz of the valid ones,
            # rows in; d xyz and the dense d packed out
            R * M * 5 + nv * 76 + 512 * nrows + R * M * 12 + ms.packed.numel() * 4, 700 * nv,
            partial(render.hits_field_fwd, ht, u, o, d, ms.packed, cfg.voxel_size),
            partial(render.hits_field_bwd, dfeats, xyz, aid, valid, ms.packed, cfg.voxel_size,
                    scratch=k2s),
        )
        log(f"[K1/K2] {name}: fwd kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms;"
            f" bwd kernel {times[name][2]:.4f} ms, plain {times[name][3]:.4f} ms")
        host_args[name] = (ht, u, o, d, ms.packed, dfeats, xyz, aid, valid, k2s, cfg.voxel_size)
        if name == "track":
            forms["hits_field_fwd, origin row stride 0"] = (times[name][8],
                                                            ("hits_field_fwd_kernel",))
            forms["hits_field_bwd, d xyz"] = (
                partial(render.hits_field_bwd, dfeats, xyz, aid, valid, ms.packed,
                        cfg.voxel_size, want_dpacked=False), ("hits_field_bwd_kernel",))
    for name, a in host_args.items():  # after the timings, which its 28,000 calls would perturb
        k12_host_costs(name, *a)
    k1, p1, k2, p2, b1, f1, b2, f2, d1, d2 = times["ba"]
    records.append(record("hits_field_fwd", "hits_field.cu", "nerfloam_tpu/core/render.py:108",
                          e1, k1, p1, b1, f1, dev=d1,
                          forms={k: v for k, v in forms.items() if "fwd" in k}))
    records.append(record("hits_field_bwd", "hits_field.cu", "nerfloam_tpu/core/ba.py:335",
                          e2p, k2, p2, b2, f2, dev=d2,
                          forms={k: v for k, v in forms.items() if "bwd" in k}))

    # ---- K8 through one ActiveField (made once, as a tracker's frame or a
    # BA step makes it): the tracker's band columns (2048, 8) with one
    # origin per ray (the record's form) and with the trackers' one origin
    # expanded to every ray (row stride 0), the bias probe over one frame's
    # measured points (65536, 1), and the replica gate's tracker (its rays
    # and samples on the grid sampler: K9b's depths, then the band columns)
    o, d, tc, ht, pts, pcos, rvalid = tables[slam.tp.n_rays]
    R = o.shape[0]
    tp = slam.tp
    o1 = o[:1].expand_as(d)
    ub = torch.rand((R, tp.band_samples), generator=gen, device=dev)
    ez = render.extra_surface_z(torch.linalg.norm(pts, dim=-1), pcos, tp.truncation,
                                tp.surface_anchor, tp.band_samples, ub)
    depth = torch.linalg.norm(p, dim=-1)
    xyz_probe = se3.transform_points(pose, p).reshape(-1, 1, 3)
    pv = v & (depth < rc_m.max_depth)
    Rg, Mg = gate_track
    og, dg, tcg, ptsg, pcosg, rvg = rays(Rg)
    og1 = og[:1].expand_as(dg)
    rc_g = rc_t._replace(sampler="grid", n_samples=Mg)
    zg, _, _, mg = (x.clone() for x in raycast.place_samples_cdf(
        ms, cfg, rc_g, *raycast.march_occupancy(ms, cfg, rc_g, og, dg, tcg), og, dg, tcg,
        raycast.uniform_jitter((Rg, Mg), gen, dev)))
    ezg = render.extra_surface_z(torch.linalg.norm(ptsg, dim=-1), pcosg, tp.truncation,
                                 tp.surface_anchor, tp.band_samples,
                                 torch.rand((Rg, tp.band_samples), generator=gen, device=dev))
    field = render.ActiveField(ms, cfg)
    k8_cases = {  # form: (rays_o, rays_d, z, ray_valid, xyz, bytes of the rays or points)
        "band": (o, d, ez, rvalid, None, R * 24),
        "band, origin row stride 0": (o1, d, ez, rvalid, None, 12 + R * 12),
        "probe": (None, None, depth.reshape(-1, 1), pv, xyz_probe, p.shape[0] * 12),
        "gate grid columns, origin row stride 0": (og1, dg, zg, mg, None, 12 + Rg * 12),
        "gate band, origin row stride 0": (og1, dg, ezg, rvg, None, 12 + Rg * 12),
    }
    e8, k8, k8_forms, k8_out = 0.0, {}, {}, {}
    for label, (ro, rd, zz, rv, xp, ray_bytes) in k8_cases.items():
        call = partial(field, ms.packed, ro, rd, zz, rv, xp)
        ker = call()
        ker2 = call()
        ref = render.active_field_fwd_plain(ms, cfg, ms.packed, ro, rd, zz, rv, xp)
        torch.cuda.synchronize()
        for i, nm in enumerate(("aid", "valid", "xyz")):
            check(torch.equal(ker[i], ref[i]), f"K8 {nm} differs ({label})")
        check(all(torch.equal(a_, b_) for a_, b_ in zip(ker, ker2)),
              f"K8 differs between two calls ({label})")
        ef = max_abs(ker[3], ref[3])
        check(ef <= 1e-6, f"K8 feats error {ef} ({label})")
        e8 = max(e8, ef)
        n, nv, nrows = ref[1].numel(), int(ref[1].sum()), rows_read(ref[0], ref[1])
        # rays (or points) + z + ray_valid + one grid cell per sample + rows
        # in; aid/valid/xyz/feats out
        nbytes = ray_bytes + n * 8 + zz.shape[0] + 512 * nrows + 81 * n
        k8[label] = (median_ms(call),
                     median_ms(partial(render.active_field_fwd_plain, ms, cfg, ms.packed, ro, rd,
                                       zz, rv, xp)), nbytes, 300 * nv + 20 * n)
        k8_out[label] = ker
        if label != "band":
            k8_forms[f"active_field_fwd, {label}"] = (call, ("active_field_fwd_kernel",))
        log(f"[K8] {label} {tuple(ref[1].shape)}: valid {nv / n:.3f}, feats err {ef:.3g}, "
            f"distinct rows {nrows}; aid, valid, xyz equal to the twin and every output to the "
            f"next call's; kernel {k8[label][0]:.4f} ms, plain {k8[label][1]:.4f} ms, bound "
            f"{bound(*k8[label][2:])[0]:.5f} ms")
    records.append(record("active_field_fwd", "active_field.cu",
                          "nerfloam_tpu/core/render.py:181", e8, *k8["band"],
                          dev=partial(field, ms.packed, o, d, ez, rvalid), forms=k8_forms))

    # ---- K3 through one GnSystem a shape (made once, as a tracker's frame
    # makes it) on one tracker iteration's real columns: the quality
    # tracker's (2048, 64 + 8) on the hit table, and the replica gate's
    # (its rays, its samples + 8) from the K8 calls above
    u = raycast.uniform_jitter((R, rc_t.n_samples), gen, dev)
    t_pos = se3.pose_translation(pose)
    dec, cdt = slam.state.decoder_params, getattr(torch, tp.compute_dtype)
    k3_cases, k3_aid = {}, {}
    for label, cols, (ro, rd, zz, rv), rp, rc_ in (
            ("quality", render.columns_fwd(ht, u, o1, d, ms.packed, cfg.voxel_size,
                                           (field, ez, rvalid)), (o1, d, ez, rvalid), pts, pcos),
            ("gate", [torch.cat(x, 1) for x in zip(
                (zg, *(k8_out["gate grid columns, origin row stride 0"][i] for i in (1, 0, 2, 3))),
                (ezg, *(k8_out["gate band, origin row stride 0"][i] for i in (1, 0, 2, 3))))],
             (og1, dg, ezg, rvg), ptsg, pcosg)):
        z, valid, aid, xyz, feats = cols
        sdf, g = tr.field_and_grad(dec, feats, xyz, aid, valid, ms.packed, cfg.voxel_size, cdt)
        d_meas = torch.linalg.norm(rp, dim=-1) * rc_
        depth_ok = (d_meas > 0.0) & (d_meas < tp.max_depth)
        bias_ray = torch.where(rc_ < 0.999, 0.01, -0.005)
        k3_cases[label] = ((xyz, t_pos, z, sdf, g, valid & rv[:, None]),
                           (rc_, d_meas, depth_ok, bias_ray))
        k3_aid[label] = aid.contiguous()
    e3, systems = 0.0, {}
    for label, (samples, per_ray) in k3_cases.items():
        system = tr.GnSystem(*per_ray, tp, samples[2].shape[1])
        systems[label] = system
        kH, kb, kl = (x.clone() for x in system(*samples))
        again = system(*samples)
        fresh = tr.GnSystem(*per_ray, tp, samples[2].shape[1])(*samples)
        rH, rb, rl = tr.gn_system_plain(*samples, *per_ray[:3], tp, per_ray[3])
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) and torch.equal(x, f_) for x, y, f_ in
                  zip((kH, kb, kl), again, fresh)),
              f"K3 differs between two calls or from a fresh GnSystem ({label})")
        check(int(system._scratch[-1:].view(torch.int32)) == 0,
              f"K3's last-block counter is not zero after a call ({label})")
        for nm, k, r in (("H", kH, rH), ("b", kb, rb), ("loss", kl, rl)):
            rel = max_abs(k, r) / max(float(r.abs().max()), 1e-30)
            check(rel <= 1e-4, f"K3 {nm} rel error {rel} ({label})")
            e3 = max(e3, max_abs(k, r))
            log(f"[K3] {label} {nm}: rel err {rel:.3g} (max |{nm}| {float(r.abs().max()):.4g})")
    # the library comparison: the einsum pair of the twin, on J, w, r
    # precomputed as the twin computes them (quality shape)
    (xyz, t_pos, z, sdf, g, vmask), (pcos_, d_meas, depth_ok, bias_ray) = k3_cases["quality"]
    T = tp.truncation
    zc = z * pcos_[:, None]
    front = (zc < (d_meas[:, None] - T)) & vmask
    band = vmask & ~front & ~(zc > (d_meas[:, None] + T)) & depth_ok[:, None]
    tot = torch.clamp(front.sum() + band.sum(), min=1).float()
    w = torch.where(front, tp.fs_weight * (1.0 - front.sum() / tot),
                    tp.sdf_weight * (1.0 - band.sum() / tot)) * (front | band)
    r = torch.where(front, sdf - 1.0, (zc + (sdf - bias_ray[:, None]) * T) - d_meas[:, None])
    gj = g * torch.where(front, 1.0, T)[..., None]
    J = torch.cat([gj, torch.linalg.cross(xyz - t_pos, gj, dim=-1)], -1)
    Jw = J * w[..., None]
    lib_ms = median_ms(lambda: (torch.einsum("nmi,nmj->ij", Jw, J),
                                torch.einsum("nmi,nm->i", Jw, r)))
    samples, per_ray = k3_cases["quality"]
    k_ms = median_ms(partial(systems["quality"], *samples))
    p_ms = median_ms(partial(tr.gn_system_plain, *samples, *per_ray[:3], tp, per_ray[3]))
    n, nv = z.numel(), int(vmask.sum())
    for label, (samples, _) in k3_cases.items():
        vm_ = samples[5]
        log(f"[K3] {label} {tuple(vm_.shape)}: {int(vm_.sum())} valid samples; two calls of "
            "one GnSystem and a fresh one equal, its counter back to zero")
    log(f"[K3] quality: front {int(front.sum())}, band {int(band.sum())}")
    # xyz/z/sdf/g/mask per sample, pcos/d/bias/ok per ray in; H, b, loss out
    records.append(record(
        "gn_system", "gn_system.cu", "nerfloam_tpu/core/tracking.py:217", e3, k_ms, p_ms,
        33 * n + 13 * R + 12 + 172, 100 * nv, lib_ms,
        dev=partial(systems["quality"], *k3_cases["quality"][0]),
        forms={"gn_system, gate": (partial(systems["gate"], *k3_cases["gate"][0]),
                                   KERNEL_FUNCTIONS["gn_system"])}))
    k38_host_costs(ms, cfg, field, k8_cases["band, origin row stride 0"][:4], tp,
                   *k3_cases["quality"])
    records.append(k3_dp_form(systems["quality"], k3_cases["quality"], tp, lib_ms))
    records.append(k3_maturity_form(k3_cases["quality"], k3_aid["quality"], tp, ms, gen, lib_ms))

    records.append(k7_phase(slam, ms, frames[3]))
    o, d, tc = tables[2 * slam.bp_current.n_rays][:3]
    records += map_kernels(slam, ms, frames, gen, (o[:1].expand_as(d), d, tc))
    records += e1_kernels(ms, cfg, gen, e1_shapes)
    records += grid_kernels(slam, ms, tables[slam.tp.n_rays], rc_gate, loops, p, c, v, pose, gen)
    records += mesh_kernels(slam, ms)
    records += s2s_kernels(slam, sp, frames, gen)
    records += tracker_step_kernels(slam, ms, frames, gen, 2 * slam.bp_current.n_rays)
    records.append(ieee_phase(p, tables[slam.tp.n_rays][4], gen))
    records.append(trig_phase(p, gen))
    records.append(exp_so3_phase(slam, gen))
    records.append(pose_rays_phase(slam, gen))
    records += ray_draw_phase(slam, frames, gen)
    records.append(const_vel_phase(gen))
    return records


def k3_dp_form(system, case, tp, lib_ms):
    """K3's dp form (``GnSystem(sums=True)``, the tracker's under a dp
    process group) at the quality tracker's shape: its 58 sums equal
    between two calls, the two counts torch.equal to ``gn_sums_plain``'s and
    each class's 28 sums within 1e-4 of them relative to their largest;
    ``gn_combine`` of them within 1e-4 of the one-launch form's H, b and
    loss. Returns its record."""
    samples, per_ray = case
    dp_system = tr.GnSystem(*per_ray, tp, samples[2].shape[1], sums=True)
    ks = dp_system(*samples).clone()
    again = dp_system(*samples)
    rs = tr.gn_sums_plain(*samples, *per_ray[:3], tp, per_ray[3])
    one = [x.clone() for x in system(*samples)]
    torch.cuda.synchronize()
    check(torch.equal(ks, again), "K3's dp form differs between two calls")
    check(torch.equal(ks[56:], rs[56:]), f"K3's dp form counts {ks[56:]} against {rs[56:]}")
    err = 0.0
    for nm, sl in (("front", slice(0, 28)), ("band", slice(28, 56))):
        rel = max_abs(ks[sl], rs[sl]) / max(float(rs[sl].abs().max()), 1e-30)
        err = max(err, max_abs(ks[sl], rs[sl]))
        check(rel <= 1e-4, f"K3's dp form {nm} sums rel error {rel}")
        log(f"[K3 dp form] {nm} sums: rel err {rel:.3g} against gn_sums_plain")
    for nm, k, r in zip(("H", "b", "loss"), tr.gn_combine(ks, tp), one):
        rel = max_abs(k, r) / max(float(r.abs().max()), 1e-30)
        check(rel <= 1e-4, f"K3's dp form combined {nm} rel error {rel}")
        log(f"[K3 dp form] gn_combine {nm}: rel err {rel:.3g} against the one-launch form")
    k_ms = median_ms(partial(dp_system, *samples))
    p_ms = median_ms(partial(tr.gn_sums_plain, *samples, *per_ray[:3], tp, per_ray[3]))
    z, vmask = samples[2], samples[5]
    n, nv, R = z.numel(), int(vmask.sum()), z.shape[0]
    return record("gn_sums", "gn_system.cu", "nerfloam_tpu/core/tracking.py:217 (under "
                  "shard_map, the psum'd counts and sums: :232-233, 310-315)", err, k_ms, p_ms,
                  33 * n + 13 * R + 12 + 232, 100 * nv, lib_ms, dev=partial(dp_system, *samples))


def k3_maturity_form(case, aid, tp, ms, gen, lib_ms):
    """K3's maturity form (``tpu_specs.maturity_warmup``: ``GnSystem(...,
    cnt=)`` called with the samples' active rows) at the quality tracker's
    shape, with BA-touch counts 0-8 drawn for the map's active rows and a
    warmup of MATURITY_WARMUP: one launch a call (its own counter), two
    calls equal, H, b and the loss within K3's 1e-4 of their largest
    entries of ``gn_system_plain`` under ``maturity_weights``; its dp form
    (sums) likewise against ``gn_sums_plain``, its counts torch.equal to the
    unweighted ones. Returns its record."""
    samples, per_ray = case
    tpm = tp._replace(maturity_warmup=MATURITY_WARMUP)
    A = ms.packed.shape[0]
    cnt = torch.randint(0, 9, (A,), generator=gen, device=ms.packed.device).to(torch.float32)
    MK = samples[2].shape[1]
    system = tr.GnSystem(*per_ray, tpm, MK, cnt=cnt)
    before = tr.gn_maturity_launches
    kH, kb, kl = (x.clone() for x in system(*samples, aid))
    again = system(*samples, aid)
    torch.cuda.synchronize()
    check(tr.gn_maturity_launches - before == 2, "K3's maturity form: not one launch a call")
    check(all(torch.equal(x, y) for x, y in zip((kH, kb, kl), again)),
          "K3's maturity form differs between two calls")
    w = tr.maturity_weights(cnt, aid, tpm)
    rH, rb, rl = tr.gn_system_plain(*samples, *per_ray[:3], tpm, per_ray[3], w)
    plain = tr.gn_system_plain(*samples, *per_ray[:3], tp, per_ray[3])
    err = 0.0
    for nm, k, r, r0 in (("H", kH, rH, plain[0]), ("b", kb, rb, plain[1]),
                         ("loss", kl, rl, plain[2])):
        rel = max_abs(k, r) / max(float(r.abs().max()), 1e-30)
        moved = max_abs(r, r0) / max(float(r.abs().max()), 1e-30)
        err = max(err, max_abs(k, r))
        check(rel <= 1e-4, f"K3's maturity form {nm} rel error {rel}")
        log(f"[K3 maturity form] {nm}: rel err {rel:.3g} against the weighted twin (the "
            f"weights move it by {moved:.3g} from the unweighted twin)")
    check(max_abs(rH, plain[0]) > 0, "K3's maturity form: the weights change nothing")
    sums_sys = tr.GnSystem(*per_ray, tpm, MK, sums=True, cnt=cnt)
    ks = sums_sys(*samples, aid).clone()
    rs = tr.gn_sums_plain(*samples, *per_ray[:3], tpm, per_ray[3], w)
    torch.cuda.synchronize()
    check(torch.equal(ks[56:], rs[56:]), f"K3's maturity dp form counts {ks[56:]} / {rs[56:]}")
    for nm, sl in (("front", slice(0, 28)), ("band", slice(28, 56))):
        rel = max_abs(ks[sl], rs[sl]) / max(float(rs[sl].abs().max()), 1e-30)
        check(rel <= 1e-4, f"K3's maturity dp form {nm} sums rel error {rel}")
        log(f"[K3 maturity form] dp form {nm} sums: rel err {rel:.3g}")
    k_ms = median_ms(partial(system, *samples, aid))
    p_ms = median_ms(partial(tr.gn_system_plain, *samples, *per_ray[:3], tpm, per_ray[3], w))
    z, vmask = samples[2], samples[5]
    n, nv, R = z.numel(), int(vmask.sum()), z.shape[0]
    # K3's bytes and an aid (4 B) a sample and the (A,) counts; its flops
    # and ~10 more a valid sample for the weight and the weighted terms
    return record("gn_system_maturity", "gn_system.cu",
                  "nerfloam_tpu/core/tracking.py:217 (with the maturity weights of :184-197, "
                  "240-241, 270, 298)", err, k_ms, p_ms, 37 * n + 13 * R + 4 * A + 12 + 172,
                  110 * nv, lib_ms, dev=partial(system, *samples, aid))


def host_trig(op, *xs):
    """The port's host copies (native/trig.cpp) over f32 numpy arrays, the
    array split across the host's cores (ctypes lets the GIL go)."""
    from nerfloam_tpu_torch import native

    lib = native.get_trig_lib()
    out = np.empty_like(xs[0])
    n = out.size
    step = -(-n // (os.cpu_count() or 1))

    def part(lo):
        m = min(step, n - lo)
        ptrs = [x.ctypes.data + 4 * lo for x in xs]
        if op == "atan2":
            lib.nl_atan2f_n(ptrs[0], ptrs[1], m, out.ctypes.data + 4 * lo)
        else:
            getattr(lib, f"nl_{op}f_n")(ptrs[0], m, out.ctypes.data + 4 * lo)

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        list(ex.map(part, range(0, n, step)))
    return out


def _same_bits(a, b):
    """Elements with the same f32 bits, or NaN on both sides."""
    return (a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a) & np.isnan(b))


def trig_phase(p, gen):
    """[trig]: csrc/trig.cu (native/trig.h compiled by nvcc) against the
    host copies (the same header by g++, native/trig.cpp), bit for bit:
    sin and cos on every f32 of [0, pi], atan2 on TRIG_PAIRS seeded pairs
    (half normal, half random bit patterns) and every pair of the specials
    (the axes, signed zeros, subnormals, signed infinities, NaN; NaN
    against NaN of any payload); the backward of each against its CPU form
    on 2^20 seeded arguments. atan2 of a frame's 65,536 points timed
    beside its plain twin (the host copy, with the copies there and back)
    and torch.atan2. Returns its record."""
    dev = p.device
    t0 = time.perf_counter()
    last = int(np.float32(np.pi).view(np.uint32))
    differ = {"sin": 0, "cos": 0, "atan2": 0}
    for lo in range(0, last + 1, TRIG_CHUNK):
        hi = min(lo + TRIG_CHUNK, last + 1)
        x_host = np.arange(lo, hi, dtype=np.uint32).view(np.float32)
        x = torch.arange(lo, hi, dtype=torch.int32, device=dev).view(torch.float32)
        for op, fn in (("sin", trig.sin), ("cos", trig.cos)):  # no NaN in [0, pi]
            differ[op] += int(np.count_nonzero(fn(x).cpu().numpy().view(np.uint32)
                                               != host_trig(op, x_host).view(np.uint32)))
    every = last + 1
    rng = np.random.default_rng(17)
    specials = np.asarray([0.0, -0.0, 1e-45, -1e-45, 1e-38, 1.0, -1.0, 3.4e38, -3.4e38, np.inf,
                           -np.inf, np.nan], np.float32)
    sy, sx = (a.ravel() for a in np.meshgrid(specials, specials))
    done = 0
    while done < TRIG_PAIRS:
        m = min(TRIG_CHUNK, TRIG_PAIRS - done)
        h = m // 2
        y, x_ = (np.concatenate([rng.normal(size=h).astype(np.float32), rng.integers(
            0, 2 ** 32, m - h, dtype=np.uint64).astype(np.uint32).view(np.float32)])
            for _ in range(2))
        if done == 0:
            y, x_ = np.concatenate([y, sy]), np.concatenate([x_, sx])
        got = trig.atan2(torch.from_numpy(y).to(dev), torch.from_numpy(x_).to(dev)).cpu().numpy()
        differ["atan2"] += int((~_same_bits(got, host_trig("atan2", y, x_))).sum())
        done += m
    log(f"[trig] csrc/trig.cu against the host copies: sin differs on {differ['sin']} and cos on "
        f"{differ['cos']} of all {every:,} floats of [0, pi]; atan2 on {differ['atan2']} of "
        f"{TRIG_PAIRS:,} seeded pairs and {len(sy)} pairs of specials "
        f"({time.perf_counter() - t0:.1f} s)")
    check(not any(differ.values()), f"[trig] the card's copies differ from the host's: {differ}")
    a = torch.randn((1 << 20,), generator=gen, device=dev) * 3.0
    b = torch.randn((1 << 20,), generator=gen, device=dev)
    g = torch.randn((1 << 20,), generator=gen, device=dev)
    for op, args in ((trig.SIN, (a, None)), (trig.COS, (a, None)), (trig.ATAN2, (a, b))):
        k = trig._launch_bwd(op, args[0], args[1], g)
        r = trig._bwd_plain(op, args[0].cpu(), None if args[1] is None else args[1].cpu(),
                            g.cpu())
        check(all(torch.equal(x.cpu(), y) for x, y in zip(k, r) if y is not None),
              f"[trig] the backward of {trig._NAMES[op]} differs from its CPU form")
    log("[trig] the backward of sin, cos and atan2 torch.equal to the CPU's on 2^20 arguments")
    y, x_ = p[:, 1].contiguous(), p[:, 0].contiguous()
    n = len(y)
    err = max_abs(trig.atan2(y, x_), trig.atan2_plain(y, x_))
    k_ms = median_ms(partial(trig.atan2, y, x_))
    p_ms = median_ms(partial(trig.atan2_plain, y, x_))
    lib_ms = median_ms(partial(torch.atan2, y, x_))
    log(f"[trig] atan2 of {n} points: kernel {k_ms:.4f} ms, the host copy with its copies "
        f"{p_ms:.4f} ms, torch.atan2 {lib_ms:.4f} ms")
    # 8 B in, 4 B out; ~40 f32 operations an atan2
    return record("trig", "trig.cu", "nerfloam_tpu/ops/se3.py:49-50, 107 and "
                  "core/scan2scan.py:73-75 (XLA's elementwise sin, cos and atan2; no TPU "
                  "kernel)", err, k_ms, p_ms, 12 * n, 40 * n, lib_ms,
                  dev=partial(trig.atan2, y, x_),
                  forms={"trig, atan2 backward": (partial(trig._launch_bwd, trig.ATAN2, y, x_,
                                                          torch.ones_like(y)),
                                                  KERNEL_FUNCTIONS["trig_bwd"])})


def exp_so3_phase(slam, gen):
    """[exp_so3]: csrc/exp_so3.cu against its plain twin (se3.exp_so3_plain,
    the chain of ops, on the CPU) on 65,536 seeded rotation vectors in each
    of three theta^2 ranges (the series, small, large): the forward
    torch.equal; the backward, against autograd of the twin with a seeded
    cotangent, within EXP_SO3_GRAD_TOL of each gradient's largest entry.
    Timed at a window's W poses (W, 6) read in place (BA's shape before
    se3.pose_rays took BA's rotations; the insert's is one pose), forward
    and backward, beside the chain on the card. Returns its record."""
    dev = slam.device
    worst = 0.0
    for lo, hi in ((0.0, 1e-8), (1e-8, 1e-2), (1e-2, 9.0)):
        d = torch.randn((65536, 3), generator=gen, device=dev)
        t2 = lo + (hi - lo) * torch.rand((65536,), generator=gen, device=dev)
        w = d / d.norm(dim=-1, keepdim=True) * t2.sqrt()[:, None]
        G = torch.randn((65536, 3, 3), generator=gen, device=dev)
        wk = w.clone().requires_grad_(True)
        R = se3.exp_so3(wk)
        (gk,) = torch.autograd.grad(R, wk, G)
        wc = w.cpu().requires_grad_(True)
        Rc = se3.exp_so3_plain(wc)
        (gc,) = torch.autograd.grad(Rc, wc, G.cpu())
        check(torch.equal(R.detach().cpu(), Rc.detach()),
              f"[exp_so3] the forward differs from its twin at theta^2 in ({lo}, {hi})")
        scale = gc.abs().amax(-1).clamp_min(1e-30)
        rel = float(((gk.cpu() - gc).abs().amax(-1) / scale).max())
        worst = max(worst, rel)
        check(rel <= EXP_SO3_GRAD_TOL, f"[exp_so3] the backward at theta^2 in ({lo}, {hi}) is "
              f"{rel:.3g} of its largest entry off its twin's (limit {EXP_SO3_GRAD_TOL})")
    log(f"[exp_so3] csrc/exp_so3.cu: the forward torch.equal to its twin's on 3 x 65,536 "
        f"rotations; the backward within {worst:.3g} of each gradient's largest entry (limit "
        f"{EXP_SO3_GRAD_TOL})")
    W = slam.window_size
    poses = torch.randn((W, 6), generator=gen, device=dev) * 0.3
    pw = poses.clone().requires_grad_(True)
    G = torch.randn((W, 3, 3), generator=gen, device=dev)

    def both(fn):
        (g,) = torch.autograd.grad(fn(pw[:, 3:6]), pw, G)
        return g

    err = max_abs(se3.pose_rotation(poses), se3.exp_so3_plain(poses[:, 3:6].cpu()).to(dev))
    k_ms = median_ms(partial(both, se3.exp_so3))
    p_ms = median_ms(partial(both, se3.exp_so3_plain))
    f_ms = median_ms(partial(se3.exp_so3, poses[:, 3:6]))
    fp_ms = median_ms(partial(se3.exp_so3_plain, poses[:, 3:6]))
    log(f"[exp_so3] a window of {W} poses, forward and backward (autograd.grad): kernel "
        f"{k_ms:.4f} ms, the chain of ops on the card {p_ms:.4f} ms; forward alone {f_ms:.4f} "
        f"and {fp_ms:.4f} ms")
    # forward 12 B in, 36 out; backward 48 in, 12 out; ~300 f32 operations each way
    return record("exp_so3", "exp_so3.cu", "nerfloam_tpu/ops/se3.py:42-62 (XLA's elementwise "
                  "chain and 3x3 dot; no TPU kernel)", err, k_ms, p_ms, 108 * W, 600 * W,
                  dev=partial(se3.pose_rotation, poses),
                  forms={"exp_so3, backward": (partial(se3.exp_so3_bwd, poses[:, 3:6], G),
                                               KERNEL_FUNCTIONS["exp_so3_bwd"])})


_DAMP_FLOOR = tuple(tuple(1e-6 if i == j else 0.0 for j in range(6)) for i in range(6))


def parent_gn_tail(pose6, H, b, lam, dirs):
    """The GN iteration's tail as the port ran it before tracking.lm_tail:
    the damping in eager operations, cuSOLVER's solve, one lm_step launch,
    and the next iteration's rotation of the rays by a cuBLAS product.
    Returns (pose, R, wdirs)."""
    Hd = H + lam * torch.diag(torch.diag(H)) + ieee.const(_DAMP_FLOOR, H.dtype, H.device)
    pose, R = tr.lm_step(pose6, torch.linalg.solve_ex(Hd, b[:, None])[0][:, 0])
    return pose, R, torch.matmul(dirs, R.transpose(-1, -2))


def parent_pose_rays(poses, dirs):
    """A pose's rays as the port made them before se3.pose_rays:
    exp_so3.cu, a batched product, the origins broadcast (and for BA's
    window, ``poses`` (W, 6) and ``dirs`` (W, N, 3), reshaped to rows: a
    copy). Returns (origins, wdirs)."""
    wdirs = torch.matmul(dirs, se3.pose_rotation(poses).transpose(-1, -2))
    if poses.dim() == 1:  # the trackers: one origin expanded
        return se3.pose_translation(poses).expand_as(wdirs), wdirs
    origins = se3.pose_translation(poses)[:, None, :].expand_as(wdirs)
    n = wdirs.shape[0] * wdirs.shape[1]
    return origins.reshape(n, 3), wdirs.reshape(n, 3)


def rays_fwd_bwd(fn, poses, dirs, go, gd):
    """``fn(poses, dirs)`` forward, then the poses' gradient from the rays'
    cotangents (go, gd) through autograd.grad: a BA or Adam iteration's
    rotation both ways."""
    p = poses.detach().requires_grad_(True)
    o, d = fn(p, dirs)
    return torch.autograd.grad((o, d), p, (go, gd))[0]


def gn_test_system(gen, n_samples=2048 * 72):
    """A seeded 6 x 6 system as K3 forms one: H = J^T diag(w) J and
    b = J^T diag(w) r over ``n_samples`` rows on the card."""
    dev = gen.device
    J = torch.randn((n_samples, 6), generator=gen, device=dev)
    w = torch.rand((n_samples,), generator=gen, device=dev)
    r = torch.randn((n_samples,), generator=gen, device=dev) * 0.1
    Jw = J * w[:, None]
    return Jw.T @ J, Jw.T @ r


def unit_dirs(shape, gen):
    d = torch.randn(tuple(shape) + (3,), generator=gen, device=gen.device)
    return d / d.norm(dim=-1, keepdim=True)


def tail_rotation_cases(gen, n_rays=2048, window=4):
    """{label: (the parent's chain, the kernel's call, (CUDA functions of
    the chain, of the kernel))} at the main path's shapes:
    the GN tail at ``n_rays`` tracker rays; a BA iteration's rotation of
    ``n_rays`` rays a frame for the current frame and a window of
    ``window`` frames; the Adam tracker's, forward and backward."""
    dev = gen.device
    H, b = gn_test_system(gen)
    pose = torch.cat([torch.randn((3,), generator=gen, device=dev) * 10,
                      torch.randn((3,), generator=gen, device=dev) * 0.3])
    dirs = unit_dirs((n_rays,), gen)
    cases = {"gn tail": (partial(parent_gn_tail, pose, H, b, 1e-2, dirs),
                         partial(tr.lm_tail, pose, H, b, 1e-2, dirs),
                         (KERNEL_FUNCTIONS["lm_step"], KERNEL_FUNCTIONS["lm_tail"]))}
    for label, W in (("BA rotation, current frame", 1), (f"BA rotation, window of {window}",
                                                         window)):
        poses = torch.cat([torch.randn((W, 3), generator=gen, device=dev) * 10,
                           torch.randn((W, 3), generator=gen, device=dev) * 0.3], 1)
        d = unit_dirs((W, n_rays), gen)
        go, gd = (torch.randn((W * n_rays, 3), generator=gen, device=dev) for _ in range(2))
        cases[label] = (partial(rays_fwd_bwd, parent_pose_rays, poses, d, go, gd),
                        partial(rays_fwd_bwd, se3.pose_rays, poses, d, go, gd),
                        (KERNEL_FUNCTIONS["exp_so3"] + KERNEL_FUNCTIONS["exp_so3_bwd"],
                         KERNEL_FUNCTIONS["pose_rays"] + KERNEL_FUNCTIONS["pose_rays_bwd"]))
    go, gd = (torch.randn((n_rays, 3), generator=gen, device=dev) for _ in range(2))
    cases["Adam tracker rotation"] = (
        partial(rays_fwd_bwd, parent_pose_rays, pose, dirs, go, gd),
        partial(rays_fwd_bwd, se3.pose_rays, pose, dirs, go, gd),
        (KERNEL_FUNCTIONS["exp_so3"] + KERNEL_FUNCTIONS["exp_so3_bwd"],
         KERNEL_FUNCTIONS["pose_rays"] + KERNEL_FUNCTIONS["pose_rays_bwd"]))
    return cases


_TINY = torch.finfo(torch.float32).tiny


def parent_draw(valid, n, gen):
    """A Gumbel top-k draw as the port made it before sampling.draw_keys:
    the keys in seven eager operations, topk, and the picks' valid
    gathered. Returns (idx, picked valid)."""
    u = torch.rand(valid.shape, generator=gen, device=valid.device)
    noise = -torch.log(-torch.log(torch.clamp(u, min=_TINY)))
    _, idx = torch.topk(torch.where(valid, 0.0, -1e9) + noise, n, dim=-1)
    return idx, torch.gather(valid, -1, idx)


def parent_tracker_draw(points, cos, valid, n, gen, trunc, max_depth, sdf_bias, rows=slice(None)):
    """A tracker's ray draw as the port made it before tracking.ray_draw
    (the GN tracker's frame and the Adam tracker's ``rays_at``): the draw,
    the rank's block, two gathers, one ray_prep launch and the band
    target in three operations. Returns (pts, pcos, rvalid, *RayPrep,
    bias_ray)."""
    ridx, rvalid = parent_draw(valid, n, gen)
    ridx, rvalid = ridx[rows], rvalid[rows]
    pts, pcos = points[ridx], cos[ridx]
    rp = tr.ray_prep(pts, pcos, trunc, max_depth)
    b2 = (torch.zeros((2,), device=pts.device) if sdf_bias is None
          else torch.as_tensor(sdf_bias, dtype=torch.float32, device=pts.device).reshape(-1)[:2])
    return pts, pcos, rvalid, *rp, torch.where(pcos < 0.999, b2[0], b2[1])


def parent_superset(points, cos, valid, K, gen, trunc, max_depth):
    """BA's ray superset as the port drew it before tracking.ray_superset:
    (W, P) points, K rays a frame. Returns (pts, cos, dirs, t_cap, dnorm,
    valid), (W, K, ...) each."""
    frame = torch.arange(points.shape[0], device=points.device)[:, None]
    sidx, svalid = parent_draw(valid, K, gen)
    sup_pts, sup_cos = points[frame, sidx], cos[frame, sidx]
    dirs, t_cap, _, _, dnorm = tr.ray_prep(sup_pts, sup_cos, trunc, max_depth)
    return sup_pts, sup_cos, dirs, t_cap, dnorm, svalid


def parent_ba_pick(sup, frame_active, N, gen, cols=slice(None), grid=False):
    """A BA iteration's pick of N rays a frame from its superset as the port
    made it before tracking.ray_pick: randint, the picks' valid, the rank's
    columns, four gathers, the frame mask and the rows (and, on the grid
    sampler, each ray's superset row). Returns (rvalid, pts, pcos, dirs,
    dnorm[, rows]) as BA reads them."""
    sup_pts, sup_cos, sup_dirs, _, sup_dnorm, svalid = sup
    W, K = svalid.shape
    dev = svalid.device
    frame = torch.arange(W, device=dev)[:, None]
    ridx = torch.randint(0, K, (W, N), generator=gen, device=dev)
    rvalid = torch.gather(svalid, 1, ridx)
    ridx, rvalid = ridx[:, cols], rvalid[:, cols]
    pts3, pcos2, dirs, dnorm = (x[frame, ridx] for x in (sup_pts, sup_cos, sup_dirs, sup_dnorm))
    rvalid = rvalid & frame_active[:, None]
    n = rvalid.numel()
    out = (rvalid.reshape(n), pts3.reshape(n, 3), pcos2.reshape(n), dirs, dnorm.reshape(n))
    return out + ((frame * K + ridx).reshape(n).to(torch.int32),) if grid else out


def parent_exact_draw(points, cos, valid, frame_active, N, gen, trunc, max_depth,
                      cols=slice(None)):
    """A BA iteration's fresh draw without a superset (the exact path) as
    the port made it before tracking.ray_draw: the draw, the rank's
    columns, two gathers, one ray_prep launch and the frame mask."""
    frame = torch.arange(points.shape[0], device=points.device)[:, None]
    ridx, rvalid = parent_draw(valid, N, gen)
    ridx, rvalid = ridx[:, cols], rvalid[:, cols]
    pts3, pcos2 = points[frame, ridx], cos[frame, ridx]
    dirs, t_cap, _, _, dnorm = tr.ray_prep(pts3, pcos2, trunc, max_depth)
    return rvalid & frame_active[:, None], pts3, pcos2, dirs, t_cap, dnorm


def parent_const_vel(last6, prev6, full):
    """The deferred warm start as the port took it before se3.const_vel:
    two pose matrices (exp_so3.cu), cuBLAS's 4 x 4 products, the inverse,
    and log_so3's eager chain with one norm3 and one trig.cu atan2."""
    t_last = se3.pose_matrix(last6)
    t_prev = se3.pose_matrix(prev6)
    rel = se3.compose_matrices(se3.invert_matrix(t_prev), t_last)
    t_const = se3.compose_matrices(t_last, rel)
    if not full:
        t_const = torch.cat([torch.cat([t_last[:3, :3], t_const[:3, 3:]], 1), t_last[3:]], 0)
    return se3.pose_from_matrix(t_const)


def tracker_draw(points, cos, valid, n, gen, trunc, max_depth, sdf_bias, rows=slice(None)):
    """A tracker's ray draw through the kernels (draw_keys, top-k,
    ray_draw), as the trackers make it."""
    return tr.ray_draw(draw_indices(valid, n, gen), rows, points, cos, valid, trunc, max_depth,
                       sdf_bias)


def superset_draw(points, cos, valid, K, gen, trunc, max_depth):
    """BA's ray superset through the kernels (draw_keys, top-k,
    ray_superset)."""
    return tr.ray_superset(draw_indices(valid, K, gen), points, cos, valid, trunc, max_depth)


def ba_pick(sup, frame_active, N, gen, cols=slice(None)):
    """A BA iteration's pick through the kernel (randint, ray_pick)."""
    W, K = sup.valid.shape
    ridx = torch.randint(0, K, (W, N), generator=gen, device=sup.valid.device)
    return tr.ray_pick(ridx, cols, sup, frame_active)


def exact_draw(points, cos, valid, frame_active, N, gen, trunc, max_depth, cols=slice(None)):
    """BA's fresh draw without a superset through the kernels (draw_keys,
    top-k, ray_draw with the frame mask)."""
    return tr.ray_draw(draw_indices(valid, N, gen), cols, points, cos, valid, trunc, max_depth,
                       frame_active=frame_active)


def draw_inputs(gen, W, P=65536):
    """Seeded frames as the draws meet them: (W, P) points 2-40 m out, their
    ground cosines (a third at 1, the ground's), 85% of them valid."""
    dev = gen.device
    d = unit_dirs((W, P), gen) * (2 + 38 * torch.rand((W, P, 1), generator=gen, device=dev))
    cos = torch.where(torch.rand((W, P), generator=gen, device=dev) < 0.33, 1.0,
                      torch.rand((W, P), generator=gen, device=dev))
    return d, cos, torch.rand((W, P), generator=gen, device=dev) < 0.85


def draw_warmstart_cases(gen, chains_only=False, n_rays=2048, window=4, trunc=0.3,
                         max_depth=40.0):
    """{label: (the parent's chain, the kernel's call or None, (CUDA
    functions of the chain, of the kernel))} at the main path's shapes: a
    tracker's draw of ``n_rays`` rays over 65,536 points (GN and Adam
    alike); BA's superset (2 n_rays of each of ``window`` frames); a BA
    iteration's pick of n_rays a frame from it (the current frame and the
    window); BA's fresh draw without a superset (the exact path, the
    window); and the deferred warm start."""
    dev = gen.device
    pts, cos, val = draw_inputs(gen, window)
    active = torch.ones((window,), dtype=torch.bool, device=dev)
    sdf_bias = torch.tensor([0.01, -0.02], device=dev)
    prep = KERNEL_FUNCTIONS["ray_prep"]
    pw = lambda nm: () if chains_only else KERNEL_FUNCTIONS[nm]  # noqa: E731
    keys = pw("draw_keys")
    cases = {"tracker draw": (
        partial(parent_tracker_draw, pts[0], cos[0], val[0], n_rays, gen, trunc, max_depth,
                sdf_bias), None if chains_only else partial(
            tracker_draw, pts[0], cos[0], val[0], n_rays, gen, trunc, max_depth, sdf_bias),
        (prep, keys + pw("ray_draw")))}
    K = 2 * n_rays
    for label, W in (("current frame", 1), (f"window of {window}", window)):
        sup = parent_superset(pts[:W], cos[:W], val[:W], K, gen, trunc, max_depth)
        cases[f"BA superset, {label}"] = (
            partial(parent_superset, pts[:W], cos[:W], val[:W], K, gen, trunc, max_depth),
            None if chains_only else partial(superset_draw, pts[:W], cos[:W], val[:W], K, gen,
                                             trunc, max_depth),
            (prep, keys + pw("ray_superset")))
        new_sup = None if chains_only else superset_draw(pts[:W], cos[:W], val[:W], K, gen,
                                                         trunc, max_depth)
        cases[f"BA pick, {label}"] = (
            partial(parent_ba_pick, sup, active[:W], n_rays, gen),
            None if chains_only else partial(ba_pick, new_sup, active[:W], n_rays, gen),
            ((), pw("ray_pick")))
    cases[f"BA exact draw, window of {window}"] = (
        partial(parent_exact_draw, pts, cos, val, active, n_rays, gen, trunc, max_depth),
        None if chains_only else partial(exact_draw, pts, cos, val, active, n_rays, gen, trunc,
                                         max_depth),
        (prep, keys + pw("ray_draw")))
    last = torch.tensor([3.1, -0.4, 0.2, 0.01, -0.02, 0.3], device=dev)
    prev = torch.tensor([2.2, -0.3, 0.21, 0.012, -0.018, 0.28], device=dev)
    cases["deferred warm start"] = (partial(parent_const_vel, last, prev, True),
                                    None if chains_only else partial(se3.const_vel, last, prev,
                                                                     True),
                                    (KERNEL_FUNCTIONS["exp_so3"] + KERNEL_FUNCTIONS["trig"]
                                     + KERNEL_FUNCTIONS["norm3"], pw("const_vel")))
    return cases


def ieee_phase(p, pts, gen):
    """[ieee]: the arithmetic the port rounds as JAX rounds it on the CPU
    (ops/ieee.py). norm3 on the card (csrc/norm3.cu) torch.equal to its
    plain form on the CPU over one frame's (65,536, 3) points and a
    tracker frame's 2048 rays, with torch.linalg.norm's rows that differ
    from it printed for the record (on the card and on the CPU); the
    scan-to-scan twin's 3- and 2-vector chains, exp_so3's sine and cosine
    (65,536 angles in each of three ranges), the 3x3 product chain and
    exp_so3 / log_so3 of 65,536 rotations equal to the CPU's; the
    routed divisions (ieee.div and rdiv, exp_so3's series coefficients,
    interp_corner_features' / voxel_size) equal to the CPU's, beside the
    rows torch's own division by a Python number gets wrong; norm3 timed
    against torch.linalg.norm in turns. Returns norm3's record."""
    p_cpu = p.cpu()
    ref = ieee.norm3(p_cpu)
    got = ieee.norm3(p)
    torch.cuda.synchronize()
    check(torch.equal(got.cpu(), ref), "[ieee] norm3 on the card differs from the CPU")
    check(torch.equal(ieee.norm3(pts).cpu(), ieee.norm3(pts.cpu())),
          "[ieee] norm3 at the tracker's rays differs from the CPU")
    check(torch.equal(ieee.norm3(p, keepdim=True).cpu(), ref[:, None]),
          "[ieee] norm3 keepdim differs from the CPU")
    lib = torch.linalg.norm(p, dim=-1)
    lib_rows = int((lib.cpu() != ref).sum())
    cpu_rows = int((torch.linalg.norm(p_cpu, dim=-1) != ref).sum())
    log(f"[ieee] norm3 on the card torch.equal to the CPU on all {len(ref)} rows of a frame's "
        f"points and on {len(pts)} tracker rays; torch.linalg.norm differs from it on {lib_rows} "
        f"rows on the card and on {cpu_rows} on the CPU")
    # the scan-to-scan twin's lengths (K11a's and K11b's chains, csrc/ieee.cuh)
    for nm, fn in (("norm3_plain", ieee.norm3_plain), ("norm2_plain", ieee.norm2_plain)):
        check(torch.equal(fn(p).cpu(), fn(p_cpu)), f"[ieee] {nm} on the card differs from the CPU")
    # exp_so3's sine and cosine (ops/trig: csrc/trig.cu on the card, the host
    # copies on the CPU) at exact-branch angles of the three ranges of theta^2
    cos_rows = {}
    for lo, hi in ((1e-8, 1e-6), (1e-6, 1e-2), (1e-2, 0.25)):
        th = torch.sqrt(torch.rand((1 << 16,), generator=gen, device=p.device) * (hi - lo) + lo)
        got_c = trig.cos(th).cpu()
        check(torch.equal(got_c, trig.cos(th.cpu())) and torch.equal(trig.sin(th).cpu(),
                                                                     trig.sin(th.cpu())),
              f"[ieee] exp_so3's sine or cosine differs from the CPU's at theta^2 in ({lo}, {hi})")
        cos_rows[lo, hi] = int((torch.cos(th).cpu() != got_c).sum())
    log("[ieee] ieee.norm3_plain / norm2_plain (the scan-to-scan twin's lengths) and exp_so3's "
        "sine and cosine (ops/trig; 65,536 angles in each theta^2 range) give the CPU's "
        "digits on the card; torch's f32 cos there differs from it on "
        + ", ".join(f"{n} ({lo:g}-{hi:g})" for (lo, hi), n in cos_rows.items()))
    # the 3x3 product as XLA's CPU dot rounds it (se3._matmul3: addcmul's fused
    # multiply-adds on the card, the chain emulated on the CPU), and exp_so3 /
    # log_so3 of seeded rotations up to pi
    A3 = torch.randn((1 << 16, 3, 3), generator=gen, device=p.device)
    B3 = torch.randn((1 << 16, 3, 3), generator=gen, device=p.device)
    check(torch.equal(se3._matmul3(A3, B3).cpu(), se3._matmul3(A3.cpu(), B3.cpu())),
          "[ieee] the 3x3 product on the card differs from the CPU's")
    w3 = torch.randn((1 << 16, 3), generator=gen, device=p.device) * 0.9
    R3 = se3.exp_so3(w3)
    check(torch.equal(R3.cpu(), se3.exp_so3(w3.cpu()))
          and torch.equal(se3.log_so3(R3).cpu(), se3.log_so3(R3.cpu())),
          "[ieee] exp_so3 or log_so3 on the card differs from the CPU's")
    mm_rows = int((torch.matmul(A3, B3).cpu() != se3._matmul3(A3.cpu(), B3.cpu())).any(-1).any(
        -1).sum())
    log(f"[ieee] the 3x3 product chain, exp_so3 and log_so3 (65,536 each) give the CPU's digits "
        f"on the card; torch.matmul there differs from the chain on {mm_rows} products")
    t2 = torch.rand((1 << 16,), generator=gen, device=p.device) * 1e-8
    for k, (a, b) in enumerate(zip(se3._sinc_coeffs(t2), se3._sinc_coeffs(t2.cpu()))):
        check(torch.equal(a.cpu(), b), f"[ieee] exp_so3's series coefficient {'AB'[k]} differs")
    x = torch.rand((1 << 16,), generator=gen, device=p.device) * 40.0 + 1e-3
    wrong = {}
    for s_ in (0.3, 0.2, 0.4, 6.0, 24.0, 120.0, 720.0):
        check(torch.equal(ieee.div(x, s_).cpu(), ieee.div(x.cpu(), s_)), f"[ieee] div by {s_}")
        check(torch.equal(ieee.rdiv(s_, x).cpu(), ieee.rdiv(s_, x.cpu())), f"[ieee] rdiv {s_}")
        wrong[s_] = int(((x / s_).cpu() != ieee.div(x.cpu(), s_)).sum())
    for vs in (0.2, 0.3, 0.4):
        c = (torch.floor(torch.randn((4096, 3), generator=gen, device=p.device) * 5) + 0.5) * vs
        q = c + (torch.rand((4096, 3), generator=gen, device=p.device) - 0.5) * vs
        f = torch.randn((4096, 8, 16), generator=gen, device=p.device)
        check(torch.equal(interp.interp_corner_features(q, c, f, vs).cpu(),
                          interp.interp_corner_features(q.cpu(), c.cpu(), f.cpu(), vs)),
              f"[ieee] interp_corner_features at voxel size {vs} differs from the CPU")
    log("[ieee] div, rdiv, exp_so3's series (65,536 angles) and interp_corner_features (voxel "
        "sizes 0.2, 0.3, 0.4) give the CPU's digits; torch's x / s on the card differs from one "
        "IEEE division on " + ", ".join(f"{n} of {len(x)} (s = {s_})" for s_, n in wrong.items()))
    n = len(p)
    k_ms, lib_ms = paired_median_ms(partial(ieee.norm3, p), partial(torch.linalg.norm, p, dim=-1))
    plain_ms = median_ms(partial(ieee.norm3_plain, p))
    k2, lib2 = paired_median_ms(partial(ieee.norm3, pts), partial(torch.linalg.norm, pts, dim=-1))
    log(f"[ieee] norm3 in turns with torch.linalg.norm: {n} rows {k_ms:.4f} against "
        f"{lib_ms:.4f} ms, {len(pts)} rows {k2:.4f} against {lib2:.4f} ms")
    return record("norm3", "norm3.cu", "nerfloam_tpu/core/tracking.py:158 (jnp.linalg.norm's "
                  "reduce fusion, at every site)", max_abs(got, ref.to(p.device)), k_ms, plain_ms,
                  16 * n, 6 * n, lib_ms, dev=partial(ieee.norm3, p),
                  forms={"norm3, R=2048": (partial(ieee.norm3, pts), KERNEL_FUNCTIONS["norm3"])})


def clone_state(ms):
    return vm.MapState(*[t.clone() for t in ms])


def median_ms_undone(fn, undo, n=TIMED_RUNS):
    """median_ms of fn (CUDA events around the call), ``undo(fn's result)``
    run after each timed call, outside the timing."""
    undo(fn())
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        undo(out)
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def k7_phase(slam, ms, frame):
    """K7 on one frame with symmetric support (3 x 65536 points), appending
    to the active set, as the quality path calls it: in place, so the
    kernel and the twin each take their own clone of the map. For bf16 and
    f32 embeddings and at the run's candidate cap and one it overflows:
    every table and the record equal to the twin's, two calls from equal
    clones equal, the kept InsertScratch's election grids all INT_MAX after
    every call, and undo_insert giving back the pre-insert tables exactly.
    Timed through the kept scratch, each call undone outside the timing."""
    dev, cfg = slam.device, slam.map_cfg
    p3, c3, v3 = frame.device_arrays(dev)
    p6 = torch.as_tensor(frame.pose6, device=dev)
    world = se3.transform_points(p6, p3)
    dirs = p3 / (torch.linalg.norm(p3, dim=-1, keepdim=True) + 1e-8)
    off = torch.where(c3[:, None] < 0.999, torch.tensor([0.0, 0.0, -1.0], device=dev),
                      se3.rotate_dirs(p6, dirs))
    pts7 = torch.cat([world, world + off * cfg.support_dist, world - off * cfg.support_dist])
    val7 = torch.cat([v3] * 3)
    cap = slam.insert_cand_cap
    k7s = vm.InsertScratch()
    for dt in (torch.bfloat16, torch.float32):
        st = ms._replace(embeddings=ms.embeddings.to(dt))
        for cap_ in (cap, 1024):  # the run's cap, and one the candidates overflow
            a, b, c = clone_state(st), clone_state(st), clone_state(st)
            ka, rec_a = vm.insert_points(a, cfg, pts7, val7, cap_, True, scratch=k7s)
            check(bool((k7s.grids == vm._INT_MAX).all()),
                  f"K7's kept election grids are not all INT_MAX after a call ({dt}, cap {cap_})")
            kb, rec_b = vm.insert_points(b, cfg, pts7, val7, cap_, True, scratch=k7s)
            ref, rec_r = vm.insert_points_plain(c, cfg, pts7, val7, cap_, True)
            torch.cuda.synchronize()
            check(ka is a and all(x.data_ptr() == y.data_ptr() for x, y in zip(ka, a)),
                  "K7 did not write into the state it was given")
            for nm in vm.MapState._fields:
                check(torch.equal(getattr(ka, nm), getattr(ref, nm)),
                      f"K7 {nm} differs from the twin ({dt}, cap {cap_})")
                check(torch.equal(getattr(ka, nm), getattr(kb, nm)),
                      f"K7 {nm} differs between two calls ({dt}, cap {cap_})")
            parts = [vm.record_parts(r) for r in (rec_a, rec_b, rec_r)]
            for nm in parts[0]:
                check(torch.equal(parts[0][nm], parts[2][nm])
                      and torch.equal(parts[0][nm], parts[1][nm]),
                      f"K7's record {nm} differs from the twin's or between calls ({dt}, "
                      f"cap {cap_})")
            check(bool((k7s.grids == vm._INT_MAX).all()),
                  f"K7's kept election grids are not all INT_MAX after a call ({dt}, cap {cap_})")
            n0 = vm.insert_undo_launches
            vm.undo_insert(ka, rec_a)
            torch.cuda.synchronize()
            check(vm.insert_undo_launches == n0 + 1, "undo_insert did not launch its kernel")
            for nm in vm.MapState._fields:
                check(torch.equal(getattr(ka, nm), getattr(st, nm)),
                      f"undo_insert left {nm} other than before the insert ({dt}, cap {cap_})")
            h = parts[0]["header"].tolist()
            log(f"[K7] {dt}, cand_cap {cap_}: {int(ref.num_cand)} candidates, {h[3]} new rows "
                f"(num_lat {h[0]} -> {int(ref.num_lat)}), {h[4]} activated, {h[5]} appended "
                f"(n_active {int(ref.n_active)}); every table and the record equal to the twin's "
                "and between two calls, the kept grids all INT_MAX after each, the undo exact")
            del a, b, c, ka, kb, ref
    # timed at the run's cap with the map's own embeddings, through the kept scratch
    a = clone_state(ms)
    ins = partial(vm.insert_points, a, cfg, pts7, val7, cap, True, scratch=k7s)
    k_ms = median_ms_undone(ins, lambda out: vm.undo_insert(*out))
    c = clone_state(ms)
    p_ms = median_ms_undone(partial(vm.insert_points_plain, c, cfg, pts7, val7, cap, True),
                            lambda out: vm.undo_insert(*out))
    _, rec = ins()
    parts = vm.record_parts(rec)
    undo_ms = median_ms(partial(vm.undo_insert, a, rec))  # a second undo writes the same
    num_lat0, n_active0, _, n_rows, n_act, n_app = parts["header"].tolist()
    nk = min(int(a.num_cand), cap)
    P, F, esz = pts7.shape[0], cfg.feat_dim, a.embeddings.element_size()
    log(f"[K7] timed: {P} points, {nk} kept candidates, {n_rows} new rows, {n_act} activated, "
        f"{n_app} appended; undo_insert {undo_ms:.4f} ms")
    k7_host_costs(a, cfg, ins, rec)
    undo_bytes = n_rows * (20 + 16) + n_act * (40 + 33) + n_app * (24 + 20 + 2 * 8 * F * 4)
    log(f"[K7] undo bound {bound(undo_bytes, 0)[0]:.5f} ms ({undo_bytes / 1e6:.3f} MB)")
    # in place at the least: each point, its cell's grid entry and surface
    # flag; 8 corner cells per kept candidate; each new row's coords and
    # grid entry written, their old values read and the record written;
    # each activated voxel's surface flag and corner rows the same; each
    # appended slot's id, coords and grid_active entry the same, its packed
    # row written, the old one read and recorded, its corners' embeddings
    bytes7 = (P * 18 + nk * 32 + n_rows * (16 + 16 + 20) + n_act * (33 + 33 + 40)
              + n_app * (20 + 20 + 24 + 3 * 8 * F * 4 + 8 * F * esz))
    return record("insert", "insert.cu", "nerfloam_tpu/map/voxel_map.py:311", 0.0, k_ms, p_ms,
                  bytes7, 10 * P, dev=partial(k7_and_undo, ins), undo_ms=undo_ms)


def k7_and_undo(ins):
    vm.undo_insert(*ins())


def k7_host_costs(ms, cfg, ins, rec):
    """Host us of K7's wrapper with the kept scratch (the insert and its
    undo; the undo alone, which a repeat leaves as it is), with a scratch
    made for the call, and the parent wrapper's eight whole-table clones
    (the card idle before each call)."""
    fresh = partial(vm.insert_points, *ins.args, **{**ins.keywords, "scratch": None})
    pieces = {
        "K7 call + undo, scratch kept": partial(k7_and_undo, ins),
        "undo_insert": partial(vm.undo_insert, ms, rec),
        "K7 call + undo, scratch made for it": partial(k7_and_undo, fresh),
        "eight table clones before": lambda: [t.clone() for t in (
            ms.lat_coords, ms.grid, ms.is_surface, ms.corner_idx, ms.active_ids,
            ms.active_coords, ms.grid_active, ms.packed)],
    }
    costs = {k: host_us_idle(fn) for k, fn in pieces.items()}
    log("[K7] host us per call (card idle before each): "
        + ", ".join(f"{k} {v:.2f}" for k, v in costs.items()))
    return costs


def distinct_corners(ms, rows):
    """Distinct embedding rows the corners of these active rows read."""
    return int(torch.unique(ms.corner_idx[ms.active_ids[rows].long()].clamp(min=0)).numel())


def e1_map(ms, cfg, C, A, gen):
    """The kernel phase's map cut to capacity C and active cap A with f32
    embeddings (the exact-gradient paths'), its active set rebuilt, and
    corner ids edited where E1's data needs them: one lattice row made a
    corner of 8 active voxels (with its own, a list of 8 or more), then one
    corner of an active voxel -1 (row 0 stands in for it). The active
    rows at n_active and past are padding."""
    n_lat = int(ms.num_lat)
    check(n_lat <= C, f"E1: {n_lat} lattice rows do not fit {C}")
    cut = {nm: getattr(ms, nm)[:C].clone() for nm in ("lat_coords", "is_surface", "corner_idx",
                                                       "upd_count")}
    ecfg = cfg._replace(capacity=C, active_cap=A, emb_dtype="float32")
    st = vm.refresh_active(ms._replace(embeddings=ms.embeddings[:C].float().contiguous(), **cut),
                           ecfg)
    n = int(st.n_active)
    check(0 < n < A, f"E1: {n} active voxels, no padding row under A = {A}")
    ids = st.active_ids[:n].long()
    cidx = st.corner_idx.clone()
    pick = torch.randperm(n, generator=gen, device=gen.device)[:8]
    shared = int(cidx[ids[pick[0]], 0])
    cidx[ids[pick], torch.arange(8, device=gen.device)] = shared
    cidx[ids[3], 5] = -1
    return st._replace(corner_idx=cidx), ecfg


def e1_kernels(ms, cfg, gen, shapes):
    """E1 (pack_embeddings and its transpose) at the exact-gradient paths'
    shapes (``shapes``: {label: (C, A)}, the first kitti_exact's): its
    forward (the pack pass) torch.equal to voxel_map.pack_embeddings, its
    transpose through one kept PackGradScratch torch.equal to
    pack_embeddings_vjp_plain (on the card) and between two calls, the
    scratch's head table all -1 after the build; timed against its plain
    version and, in turns, the library call (index_select; index_add_,
    whose float atomics add in another order: held within 1e-5 of the
    largest entry)."""
    records = []
    for label, (C, A) in shapes.items():
        st, ecfg = e1_map(ms, cfg, C, A, gen)
        n, F = int(st.n_active), ecfg.feat_dim
        emb = st.embeddings
        fwd = vm.pack_embeddings_fwd(st, ecfg, emb)
        fref = vm.pack_embeddings(st, ecfg)
        d = torch.zeros((A, 8 * F), device=emb.device)
        d[:n] = torch.randn((n, 8 * F), generator=gen, device=emb.device) * torch.exp2(
            torch.randint(-10, 10, (n, 8 * F), generator=gen, device=emb.device).float())
        scratch = vm.PackGradScratch().build(st, ecfg)
        k1 = vm.pack_embeddings_vjp(d, scratch)
        k2 = vm.pack_embeddings_vjp(d, scratch)
        ref = vm.pack_embeddings_vjp_plain(d, st.active_ids, st.corner_idx, st.n_active, C)
        torch.cuda.synchronize()
        check(torch.equal(fwd, fref), f"E1 forward differs from pack_embeddings ({label})")
        check(torch.equal(k1, ref), f"E1 transpose differs from its twin ({label})")
        check(torch.equal(k1, k2), f"E1 transpose differs between calls ({label})")
        check(bool((scratch._bufs[0] == -1).all()), f"E1's head table not reset ({label})")
        idx = torch.clamp(st.corner_idx[st.active_ids[:n].long()], min=0).reshape(-1)
        counts = torch.bincount(idx, minlength=C)
        log(f"[E1] {label}: C={C}, A={A}, {n} active rows ({A - n} padding), "
            f"{int(torch.unique(idx).numel())} corners, longest list {int(counts.max())} (row 0: "
            f"{int(counts[0])}); forward torch.equal to pack_embeddings, transpose torch.equal to "
            "pack_embeddings_vjp_plain and between two calls through one kept PackGradScratch")
        lib_idx = torch.clamp(st.corner_idx[st.active_ids.long()], min=0).reshape(-1)
        dn = d[:n].reshape(-1, F)

        def lib_bwd(idx=idx, dn=dn, C=C, F=F):
            return torch.zeros((C, F), device=dn.device).index_add_(0, idx, dn)

        lib_fwd = partial(lambda e, i, A=A, F=F: torch.index_select(e, 0, i).view(A, 8 * F),
                          emb, lib_idx)
        lb = lib_bwd()
        check(torch.equal(lib_fwd(), fwd), f"index_select differs from E1's forward ({label})")
        e_lib = max_abs(lb, k1) / max(float(k1.abs().max()), 1e-30)
        check(e_lib <= 1e-5, f"index_add_ beyond 1e-5 of E1's transpose ({label}): {e_lib}")
        kf = partial(vm.pack_embeddings_fwd, st, ecfg, emb)
        kb = partial(vm.pack_embeddings_vjp, d, scratch)
        kbuild = partial(scratch.build, st, ecfg)
        nc = int(torch.unique(lib_idx).numel())
        # forward: active ids and corner ids of every row, distinct corners read, the table
        # written; transpose: d packed of the active rows, the sorted heads and links, d emb
        # written; build: ids and corner ids read, links and heads written
        nb = {"fwd": A * 4 + A * 32 + nc * F * 4 + A * 8 * F * 4,
              "bwd": n * 8 * F * 4 + C * 4 + 8 * n * 4 + C * F * 4,
              "build": n * 4 + n * 32 + 2 * 8 * n * 4 + 2 * C * 4}
        fl = {"fwd": 0, "bwd": 8 * n * F, "build": 0}
        log(f"[E1] {label}: forward bound {bound(nb['fwd'], 0)[0]:.5f} ms, transpose "
            f"{bound(nb['bwd'], fl['bwd'])[0]:.5f} ms, build {bound(nb['build'], 0)[0]:.5f} ms; "
            f"index_add_ within {e_lib:.2e} of the largest entry")
        build_form = {f"pack_embeddings_vjp, build, {label}":
                      (kbuild, KERNEL_FUNCTIONS["pack_embeddings_vjp_build"])}
        if records:  # a further shape: its forms, profiled with the first shape's records
            records[0]["_forms"][f"pack_embeddings, {label}"] = (
                kf, KERNEL_FUNCTIONS["pack_embeddings"])
            records[1]["_forms"].update({f"pack_embeddings_vjp, {label}": (
                kb, KERNEL_FUNCTIONS["pack_embeddings_vjp"]), **build_form})
            continue
        k_f, l_f = paired_median_ms(kf, lib_fwd)
        k_b, l_b = paired_median_ms(kb, lib_bwd)
        p_f = median_ms(partial(vm.pack_embeddings, st, ecfg))
        p_b = median_ms(partial(vm.pack_embeddings_vjp_plain, d, st.active_ids, st.corner_idx,
                                st.n_active, C))
        log(f"[E1] {label}: build {median_ms(kbuild):.4f} ms a BA step (two launches)")
        records.append(record("pack_embeddings", "active_set.cu",
                              "nerfloam_tpu/map/voxel_map.py:301", 0.0, k_f, p_f, nb["fwd"],
                              fl["fwd"], l_f, dev=kf))
        records.append(record("pack_embeddings_vjp", "pack_grad.cu", "nerfloam_tpu/core/ba.py:222",
                              0.0, k_b, p_b, nb["bwd"], fl["bwd"], l_b, dev=kb, forms=build_form,
                              library_max_rel_err=e_lib))
    return records


def map_kernels(slam, ms, frames, gen, k4_rays):
    """K6 (recenter + refresh) one frame's move away, and K5 (reconcile +
    repack) on a touched set of the quality cap, against their twins; the
    host costs of K4's and K5's wrappers (``k4_rays``: BA's superset, see
    k45_host_costs)."""
    dev, cfg = slam.device, slam.map_cfg
    records = []
    # ---- K6: the region moved to the second frame's position
    center = torch.as_tensor(frames[1].pose6[:3], device=dev)
    kr, rr = vm.recenter(ms, cfg, center), vm.recenter_plain(ms, cfg, center)
    kf, rf = vm.refresh_active(kr, cfg), vm.refresh_active_plain(kr, cfg)
    torch.cuda.synchronize()
    for nm in ("grid", "region_min"):
        check(torch.equal(getattr(kr, nm), getattr(rr, nm)), f"K6 recenter {nm} differs")
    for nm in ("active_ids", "n_active", "grid_active", "packed", "active_coords"):
        check(torch.equal(getattr(kf, nm), getattr(rf, nm)), f"K6 refresh {nm} differs")
    A, total, F = rf.packed.shape[0], rf.grid_active.numel(), cfg.feat_dim
    n_lat, n_act = int(ms.num_lat), min(int(rf.n_active), A)
    log(f"[K6] {n_lat} lattice rows, grid {total} cells, {int(rf.n_active)} active (A={A}); "
        "every table equal")
    k_ms = median_ms(lambda: vm.refresh_active(vm.recenter(ms, cfg, center), cfg))
    p_ms = median_ms(lambda: vm.refresh_active_plain(vm.recenter_plain(ms, cfg, center), cfg))
    esz = ms.embeddings.element_size()
    # lattice coords + surface flags of the allocated rows in; both grids
    # out; the active rows' corner ids and distinct corner embeddings in;
    # active ids, coords and packed rows out
    records.append(record(
        "active_set", "active_set.cu", "nerfloam_tpu/map/voxel_map.py:149",
        0.0, k_ms, p_ms,
        n_lat * 13 + 2 * 4 * total + n_act * 32
        + distinct_corners(rf, torch.arange(n_act, device=dev)) * F * esz + A * (4 + 12 + 512),
        20 * n_lat,
        dev=lambda: vm.refresh_active(vm.recenter(ms, cfg, center), cfg)))

    # ---- K5: a touched set of ~60% of the quality cap, 0.01-sized deltas;
    # each call without a scratch and through one ReconcileScratch kept over
    # the calls (as the pipeline keeps it)
    T = slam.bp_current.touched_cap
    st = kf
    pick = torch.rand((A,), generator=gen, device=dev) < min(1.0, 0.6 * T / max(n_act, 1))
    touched = pick & (torch.arange(A, device=dev) < n_act)
    new_packed = st.packed + 0.01 * torch.randn(st.packed.shape, generator=gen, device=dev)
    k5s = vm.ReconcileScratch()
    e5 = 0.0
    for dt in (torch.bfloat16, torch.float32):
        s5 = st._replace(embeddings=st.embeddings.to(dt))
        s5 = s5._replace(packed=vm.pack_embeddings(s5, cfg))
        np5 = (s5.packed + (new_packed - st.packed)).contiguous()
        k1 = vm.reconcile(s5, cfg, np5, touched, T)
        k2 = vm.reconcile(s5, cfg, np5, touched, T, scratch=k5s)
        k3 = vm.reconcile(s5, cfg, np5, touched, T, scratch=k5s)
        cpu = vm.MapState(*[x.cpu() for x in s5])
        ref = vm.reconcile_plain(cpu, cfg, np5.cpu(), touched.cpu(), T)
        torch.cuda.synchronize()
        for nm in vm.Reconciled._fields:
            check(torch.equal(getattr(k1, nm), getattr(k2, nm))
                  and torch.equal(getattr(k1, nm), getattr(k3, nm)),
                  f"K5 {nm} differs between calls ({dt})")
        check(bool((k5s.head == -1).all()) and not bool(k5s.scan_state.any()),
              f"K5's kept scratch is not reset after a call ({dt})")
        for nm in ("packed", "upd_count", "touched_count"):
            check(torch.equal(getattr(k1, nm).cpu(), getattr(ref, nm)), f"K5 {nm} differs ({dt})")
        diff = k1.embeddings.cpu().float() - ref.embeddings.float()
        if dt == torch.float32:
            check(torch.equal(k1.embeddings.cpu(), ref.embeddings), "K5 f32 embeddings differ")
        else:  # within one bf16 ulp of the twin (2^-7 of the value's binade)
            ulp = torch.exp2(torch.floor(torch.log2(ref.embeddings.float().abs().clamp(min=1e-30)))
                             - 7)
            check(bool((diff.abs() <= ulp).all()), "K5 bf16 embeddings beyond one ulp")
        e5 = max(e5, float(diff.abs().max()))
        log(f"[K5] {dt}: {int(ref.touched_count)} touched of cap {T}, A={A}; embeddings "
            f"{'identical' if bool((diff == 0).all()) else 'within one ulp'} to the twin on the "
            "CPU, every table bit-identical across three calls (one without a scratch, two "
            "through one kept scratch, its head table all -1 and scan states zero after them)")
        # the sum form (reconcile_mode=sum): the deltas added undivided
        s1 = vm.reconcile(s5, cfg, np5, touched, T, scratch=k5s, mode="sum")
        s2 = vm.reconcile(s5, cfg, np5, touched, T, scratch=k5s, mode="sum")
        sref = vm.reconcile_plain(cpu, cfg, np5.cpu(), touched.cpu(), T, "sum")
        torch.cuda.synchronize()
        for nm in vm.Reconciled._fields:
            check(torch.equal(getattr(s1, nm), getattr(s2, nm)),
                  f"K5's sum form: {nm} differs between calls ({dt})")
            check(torch.equal(getattr(s1, nm).cpu(), getattr(sref, nm)),
                  f"K5's sum form: {nm} differs from the twin ({dt})")
        check(not torch.equal(s1.embeddings, k1.embeddings), f"K5's sum form equals mean ({dt})")
        log(f"[K5] {dt}, sum form: every table torch.equal to the twin's (on the CPU) and "
            "between two calls through the kept scratch")
    nt = min(int(touched.sum()), T)
    trows = torch.nonzero(touched).squeeze(1)[:nt]
    nc = distinct_corners(st, trows)
    k5 = partial(vm.reconcile, st, cfg, new_packed, touched, T, scratch=k5s)
    k_ms = median_ms(k5)
    p_ms = median_ms(lambda: vm.reconcile_plain(st, cfg, new_packed, touched, T))
    log(f"[K5] without a kept scratch (a (C,) fill a call): "
        f"{median_ms(partial(vm.reconcile, st, cfg, new_packed, touched, T)):.4f} ms; its two "
        f"clones alone (the replay's pre-step tables kept): embeddings "
        f"{median_ms(st.embeddings.clone):.4f} ms, upd_count {median_ms(st.upd_count.clone):.4f} ms")
    k45_host_costs(ms, cfg, slam.rc_track, k4_rays, st, new_packed, touched, T, k5s)
    # touched mask + active ids in; old and new packed rows and corner ids
    # of the kept rows; their distinct corners read and written; the
    # touched voxels' counts; the repack: every active row's corner ids and
    # distinct corners in, the packed table out
    records.append(record(
        "reconcile", "reconcile.cu", "nerfloam_tpu/map/voxel_map.py:233", e5, k_ms, p_ms,
        A * 5 + nt * (2 * 512 + 32) + 2 * nc * F * esz + int(touched.sum()) * 8
        + A * 32 + distinct_corners(st, torch.arange(n_act, device=dev)) * F * esz + A * 512,
        nt * 8 * F * 4, dev=k5))
    return records


def host_us_idle(fn, calls=50):
    """Mean host microseconds from the call to its return, the card idle
    before each call (synchronised first): a wrapper's host cost where its
    device time is longer than it, which a loop of calls would time."""
    total = 0.0
    fn()
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / calls * 1e6


def k45_host_costs(ms, cfg, rc, k4_rays, st, new_packed, touched, T, k5s):
    """Host us of K4's and K5's wrappers (the card idle before each call)
    beside what their earlier forms did instead: K4's conversions of its
    inputs (``.float()`` / ``.to(torch.int32)`` and ``.contiguous()``,
    which copies an expanded origin) and BA's pack of the table in torch
    (``pack_hit_table``: two casts and a concatenation), K5's
    ``torch.cumsum`` of the touched mask and the clone of its last entry,
    and the kept scratch against one made for the call. K4 at BA's
    superset with one origin expanded to every ray (``k4_rays``: rays_o,
    rays_d, t_cap)."""
    o1, d, tc = k4_rays
    ht = raycast.build_hit_table(ms, cfg, rc, o1, d, tc)
    pieces = {
        "K4 call, origin row stride 0": partial(raycast.build_hit_table, ms, cfg, rc, o1, d, tc),
        "K4 packed call": partial(raycast.build_hit_table_packed, ms, cfg, rc, o1, d, tc),
        "K4 conversions before": lambda: [t.contiguous() for t in (
            ms.grid_active, ms.region_min.to(torch.int32), o1.float(), d.float(), tc.float())],
        "pack_hit_table (BA's torch pack before)": partial(raycast.pack_hit_table, ht),
        "K5 call, scratch kept": partial(vm.reconcile, st, cfg, new_packed, touched, T,
                                         scratch=k5s),
        "K5 call, scratch made for it": partial(vm.reconcile, st, cfg, new_packed, touched, T),
        "K5 cumsum and count clone before": lambda: torch.cumsum(touched, 0,
                                                                 dtype=torch.int32)[-1].clone(),
    }
    costs = {k: host_us_idle(fn) for k, fn in pieces.items()}
    log("[K4/K5] host us per call (card idle before each): "
        + ", ".join(f"{k} {v:.2f}" for k, v in costs.items()))
    return costs


def host_us(fn, calls=2000):
    """Mean host microseconds of one call of fn (the GPU is synchronised
    before and after the calls, not between them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def k9b_host_costs(ms, cfg, rc, cdf, n_occ, o, d, tc, u, q):
    """Host us of K9b's wrapper and of what it is built from, at one
    shape: the placer made and called, torch.searchsorted, the outputs
    allocated four times or as views of one buffer, the stream lookup."""
    dev, (R, M) = d.device, u.shape
    placer = raycast.CdfPlacer(ms, cfg, rc, cdf, n_occ, tc, M)

    def one_buffer_views():
        buf = torch.empty((9 * R * M + R,), dtype=torch.uint8, device=dev)
        zb, ab, vb, mb = buf.split_with_sizes([4 * R * M, 4 * R * M, R * M, R])
        return (zb.view(torch.float32).view(R, M), ab.view(torch.int32).view(R, M),
                vb.view(torch.bool).view(R, M), mb.view(torch.bool))

    pieces = {
        "CdfPlacer made": lambda: raycast.CdfPlacer(ms, cfg, rc, cdf, n_occ, tc, M),
        "CdfPlacer call": lambda: placer(o, d, u),
        "torch.searchsorted": lambda: torch.searchsorted(cdf, q),
        "4 x torch.empty (the outputs)": lambda: (
            torch.empty((R, M), dtype=torch.float32, device=dev),
            torch.empty((R, M), dtype=torch.int32, device=dev),
            torch.empty((R, M), dtype=torch.bool, device=dev),
            torch.empty((R,), dtype=torch.bool, device=dev)),
        "one buffer cut into views": one_buffer_views,
        "kernels.stream_ptr": lambda: kernels.stream_ptr(dev),
        "torch.cuda.current_stream().cuda_stream": lambda: torch.cuda.current_stream(dev)
        .cuda_stream,
    }
    costs = {k: host_us(fn) for k, fn in pieces.items()}
    log("[K9b] host us per call: " + ", ".join(f"{k} {v:.2f}" for k, v in costs.items()))
    return costs


def k9a_host_costs(ms, cfg, rc, o1, d, tc, M):
    """Host us of a tracker frame's march + placer made (the card idle
    before each call), one origin expanded to every ray: CdfPlacer.march
    (one object, the map and t_cap checked once, one PlaceArgs for both
    passes, no copy) beside march_occupancy + CdfPlacer over its cdf (two
    placers made) and the conversions the earlier march made first
    (``.float()`` / ``.to(torch.int32)`` and ``.contiguous()``, which copies
    the expanded origin)."""
    pieces = {
        "CdfPlacer.march": partial(raycast.CdfPlacer.march, ms, cfg, rc, o1, d, tc, M),
        "march_occupancy + CdfPlacer": lambda: raycast.CdfPlacer(
            ms, cfg, rc, *raycast.march_occupancy(ms, cfg, rc, o1, d, tc), tc, M),
        "march_occupancy": partial(raycast.march_occupancy, ms, cfg, rc, o1, d, tc),
        "the earlier march's conversions": lambda: [t.contiguous() for t in (
            ms.grid_active, ms.region_min.to(torch.int32), o1.float(), d.float(), tc.float())],
    }
    costs = {k: host_us_idle(fn) for k, fn in pieces.items()}
    log("[K9a] host us per call, a tracker frame's march + placer (card idle before each): "
        + ", ".join(f"{k} {v:.2f}" for k, v in costs.items()))
    return costs


def k10a_host_costs(ms, cfg, ids, res):
    """Host us of K10a's wrapper (the card idle before each call) beside
    its checks alone and the conversions the earlier wrapper made instead
    (``.to(torch.int32).contiguous()`` of the ids and ``.contiguous()`` of
    the three tables, each a no-op on these inputs, not a check)."""
    pieces = {
        "mesh_lattice": partial(mesher.mesh_lattice, ms, cfg, ids, res),
        "its checks (_lattice_inputs)": partial(mesher._lattice_inputs, ms, cfg, ids, res),
        "the earlier wrapper's conversions": lambda: (ids.to(torch.int32).contiguous(), [
            t.contiguous() for t in (ms.corner_idx, ms.lat_coords, ms.embeddings)]),
    }
    costs = {k: host_us_idle(fn) for k, fn in pieces.items()}
    log(f"[K10a] host us per call, res {res}, {ids.numel()} voxels (card idle before each): "
        + ", ".join(f"{k} {v:.2f}" for k, v in costs.items()))
    return costs


def k12_host_costs(label, ht, u, o, d, packed, dfeats, xyz, aid, valid, k2, vs):
    """Host us of K1's and K2's wrappers and of their checks, beside the
    conversions their earlier wrappers made instead (each input through
    ``.float()`` / ``.to(torch.int32)`` and ``.contiguous()``, which copies
    an expanded origin), at one shape. The d packed call itself is left
    out: its device time (~64 us) is longer than its host time, so a loop
    of calls would time the card."""
    pieces = {
        "K1 call": lambda: render.hits_field_fwd(ht, u, o, d, packed, vs),
        "K1 checks": lambda: render._check_fwd(ht, u, o, d, packed),
        "K1 conversions before": lambda: [t.contiguous() for t in (
            ht.aid.to(torch.int32), ht.t_near.float(), ht.seg.float(), ht.cdf.float(),
            ht.cell.to(torch.int32), u.float(), o.float(), d.float(), packed.float())],
        "K2 d xyz call": lambda: render.hits_field_bwd(dfeats, xyz, aid, valid, packed, vs,
                                                       want_dpacked=False),
        "K2 checks": lambda: render._check_bwd(dfeats, xyz, aid, valid, packed),
        "K2 conversions before": lambda: [t.contiguous() for t in (
            dfeats.float(), xyz.float(), aid.to(torch.int32), valid, packed.float())],
        "K2 scratch kept": lambda: k2.fit(packed.device, packed.shape[0], valid.numel()),
    }
    costs = {k: host_us(fn) for k, fn in pieces.items()}
    log(f"[K1/K2] {label} host us per call: "
        + ", ".join(f"{k} {v:.2f}" for k, v in costs.items()))
    return costs


def k38_host_costs(ms, cfg, field, k8_args, tp, k3_samples, k3_rays):
    """Host us of K8's and K3's per-frame objects (made, and called), of
    their function forms (an object made for the one call), and of what
    their earlier wrappers did instead of the checks: each input through
    ``.float()`` / ``.to(...)`` and ``.contiguous()`` (which copies an
    expanded origin) and the outputs (and K3's partial rows) allocated per
    call. K8 at the band shape with the trackers' shared origin, K3 at the
    quality tracker's."""
    o, d, z, rv = k8_args
    dev, (R, K) = z.device, z.shape
    xyz, t_pos, zz, sdf, g, vmask = k3_samples
    pcos, d_meas, depth_ok, bias_ray = k3_rays
    N, MK = zz.shape
    system = tr.GnSystem(pcos, d_meas, depth_ok, bias_ray, tp, MK)
    pieces = {
        "ActiveField call": partial(field, ms.packed, o, d, z, rv),
        "ActiveField made": partial(render.ActiveField, ms, cfg),
        "active_field_fwd": partial(render.active_field_fwd, ms, cfg, ms.packed, o, d, z, rv),
        "K8 conversions and outputs before": lambda: (
            [t.contiguous() for t in (o.float(), d.float(), z.float(), rv.to(torch.bool),
                                      ms.grid_active, ms.region_min.to(torch.int32),
                                      ms.packed.float())],
            torch.empty((R, K), dtype=torch.int32, device=dev),
            torch.empty((R, K), dtype=torch.bool, device=dev),
            torch.empty((R, K, 3), dtype=torch.float32, device=dev),
            torch.empty((R, K, 16), dtype=torch.float32, device=dev)),
        "GnSystem call": partial(system, *k3_samples),
        "GnSystem made": partial(tr.GnSystem, *k3_rays, tp, MK),
        "gn_system": partial(tr.gn_system, xyz, t_pos, zz, sdf, g, vmask, pcos, d_meas, depth_ok,
                             tp, bias_ray),
        "K3 conversions and outputs before": lambda: (
            [t.contiguous() for t in (xyz.float(), zz.float(), sdf.float(), g.float(),
                                      vmask.to(torch.bool), pcos.float(), d_meas.float(),
                                      depth_ok.to(torch.bool), bias_ray.float(), t_pos.float())],
            torch.empty((min(256, (N * MK + 255) // 256), 58), dtype=torch.float32, device=dev),
            torch.empty((6, 6), dtype=torch.float32, device=dev),
            torch.empty((6,), dtype=torch.float32, device=dev),
            torch.empty((), dtype=torch.float32, device=dev)),
    }
    costs = {k: host_us(fn) for k, fn in pieces.items()}
    log("[K3/K8] host us per call: " + ", ".join(f"{k} {v:.2f}" for k, v in costs.items()))
    return costs


def gate_k2(ms, cfg, place, o, d, gen):
    """K2 at the replica gate's BA shape (its grid sampler: K9b's depths,
    K8's features): d packed equal to its row-order oracle and from call to
    call, within 1e-5 of the twin's largest entry."""
    z, _, _, ray_mask = place()
    aid, valid, xyz, feats = render.ActiveField(ms, cfg)(ms.packed, o, d, z, ray_mask)
    dfeats = torch.randn(feats.shape, generator=gen, device=feats.device)
    k2 = render.DpackedScratch()
    kx, kp = render.hits_field_bwd(dfeats, xyz, aid, valid, ms.packed, cfg.voxel_size, scratch=k2)
    kx2, kp2 = render.hits_field_bwd(dfeats, xyz, aid, valid, ms.packed, cfg.voxel_size,
                                     scratch=k2)
    _, rp = render.hits_field_bwd_plain(dfeats, xyz, aid, valid, ms.packed, cfg.voxel_size, True)
    torch.cuda.synchronize()
    check(torch.equal(kx, kx2) and torch.equal(kp, kp2), "K2 differs between two calls (gate)")
    check(torch.equal(kp, render.dpacked_in_row_order_plain(dfeats, xyz, aid, valid, len(kp),
                                                            cfg.voxel_size)),
          "K2 d packed differs from its row-order oracle (gate)")
    ep = max_abs(kp, rp)
    check(ep <= 1e-5 * float(rp.abs().max()), f"K2 d packed error {ep} (gate)")
    log(f"[K2] gate60 {tuple(valid.shape)}: d packed equal to dpacked_in_row_order_plain, err "
        f"{ep:.3g} against the twin; samples per touched row "
        f"{samples_per_row(aid, valid, len(kp))}")


def grid_kernels(slam, ms, tab, rc_gate, loops, p, c, v, pose, gen):
    """K9a and K9b at the Adam tracker's shapes (the tracker's 2048 rays)
    and at the replica gate's BA superset (768 rays, its own slots and
    samples), the placement 1 cm off the march's origin. K9b is checked in
    three forms: place_samples_cdf with one origin per ray; a CdfPlacer
    with one origin broadcast to every ray (row stride 0; the trackers'
    form, a placer per frame); and a CdfPlacer over the whole superset
    whose calls take half of its rows through ``rows`` (BA's form, a placer
    per step). The trackers' form is timed at the Adam shapes, BA's at the
    gate's, each per call and with the placer's making spread over the
    ``loops`` iterations of a frame or step (the record's time is the Adam
    tracker's), in turns with torch.searchsorted over the same cdf rows
    and quantiles, K9b's library call."""
    dev, cfg = slam.device, slam.map_cfg
    rc_adam = slam.rc_track._replace(sampler="grid")
    o, d, tc = tab[:3]
    idx, _ = sample_ray_indices(v, 768, gen)
    rp = tr.ray_prep(p[idx], c[idx], 0.3, rc_gate.max_depth)
    dg = se3.rotate_dirs(pose, rp.dirs).contiguous()
    og = se3.pose_translation(pose).expand_as(dg).contiguous()
    shapes = {"adam25": (rc_adam, o, d, tc, "shared origin"),
              "gate60": (rc_gate, og, dg, rp.t_cap, "superset rows")}
    out = {}
    for label, (rc, ro, rd, rt, timed) in shapes.items():
        cstep, S = raycast._coarse_shape(rc)
        C, M = ro.shape[0], rc.n_samples
        pc, pn = raycast.march_occupancy_plain(ms, cfg, rc, ro, rd, rt)
        ro1 = ro[:1].expand_as(rd)  # the trackers' form: one origin, row stride 0
        p1c, p1n = raycast.march_occupancy_plain(ms, cfg, rc, ro1, rd, rt)
        march_forms = {  # K9a's two wrappers in both origin forms, against the twin
            "march_occupancy": (partial(raycast.march_occupancy, ms, cfg, rc, ro, rd, rt),
                                (pc, pn)),
            "march_occupancy, origin row stride 0": (
                partial(raycast.march_occupancy, ms, cfg, rc, ro1, rd, rt), (p1c, p1n)),
            "CdfPlacer.march": (partial(raycast.CdfPlacer.march, ms, cfg, rc, ro, rd, rt, M),
                                (pc, pn)),
            "CdfPlacer.march, origin row stride 0": (
                partial(raycast.CdfPlacer.march, ms, cfg, rc, ro1, rd, rt, M), (p1c, p1n)),
        }
        for form, (march, (tcdf, tn)) in march_forms.items():
            n0 = raycast.march_occupancy_launches
            got = march()
            kc, kn = (got.cdf, got.n_occ) if isinstance(got, raycast.CdfPlacer) else got
            torch.cuda.synchronize()
            check(raycast.march_occupancy_launches == n0 + 1, f"K9a {form}: not one launch")
            check(torch.equal(kc, tcdf) and torch.equal(kn, tn),
                  f"K9a cdf/n_occ differ from the twin's ({label}, {form})")
        log(f"[K9a] {label} C={C} S={S}: cdf and n_occ equal to the twin through march_occupancy "
            "and CdfPlacer.march, with one origin per ray and with one origin expanded (row "
            "stride 0)")
        u = raycast.uniform_jitter((C, M), gen, dev)
        o2 = (ro + 0.01).contiguous()
        o1 = (ro[0] + 0.01).expand_as(rd)
        rows = torch.randperm(C, generator=gen, device=dev)[:C // 2].to(torch.int32)
        ri = rows.long()
        R2 = rows.shape[0]
        o_r, d_r, u_r = o2[ri].contiguous(), rd[ri].contiguous(), u[:R2]
        # the placers' makers (a tracker's once per frame, BA's once per
        # step), their calls' arguments and the twin's inputs
        makers = {"shared origin": partial(raycast.CdfPlacer, ms, cfg, rc, pc, pn, rt, M),
                  "superset rows": partial(raycast.CdfPlacer, ms, cfg, rc, pc, pn, rt, M, R2)}
        call_args = {"shared origin": (o1, rd, u), "superset rows": (o_r, d_r, u_r, rows)}
        forms = {  # form: (its call, the plain twin's inputs)
            "rows": (partial(raycast.place_samples_cdf, ms, cfg, rc, pc, pn, o2, rd, rt, u),
                     (pc, pn, o2, rd, rt, u)),
            "shared origin": (partial(makers["shared origin"](), *call_args["shared origin"]),
                              (pc, pn, o1, rd, rt, u)),
            "superset rows": (partial(makers["superset rows"](), *call_args["superset rows"]),
                              (pc[ri], pn[ri], o_r, d_r, rt[ri], u_r)),
        }
        ez = 0.0
        for form, (place, ins) in forms.items():
            ker = place()
            ref = raycast.place_samples_cdf_plain(ms, cfg, rc, *ins)
            torch.cuda.synchronize()
            for i, nm in ((1, "aid"), (2, "valid"), (3, "ray_mask")):
                check(torch.equal(ker[i], ref[i]), f"K9b {nm} differs ({label}, {form})")
            zk, zr = ker[0], ref[0]
            ulp1 = torch.nextafter(zr, torch.full_like(zr, float("inf"))) - zr
            ez = max(ez, float((zk - zr).abs().max()))
            check(bool(((zk - zr).abs() <= ulp1).all()), f"K9b z beyond one ulp ({label}, {form})")
            log(f"[K9b] {label} {form}: aid, valid, ray_mask equal to the twin, valid "
                f"{float(ref[2].float().mean()):.3f}")
        if label == "gate60":
            gate_k2(ms, cfg, forms["superset rows"][0], o_r, d_r, gen)
        in_range = int(((torch.arange(S, device=dev) + 0.5)[None, :] * cstep
                        <= rt[:, None]).sum())
        log(f"[K9] {label} C={C} S={S} M={M}: rays hit {float(pn.gt(0).float().mean()):.3f}, "
            f"occupied slots/ray {float(pn.mean()):.2f}, z err {ez:.3g}")
        # the timed form: its rays, cdf rows and quantiles
        place, ins = forms[timed]
        tcdf, tn, tu = ins[0], ins[1], ins[5]
        R = tu.shape[0]
        q = raycast.div(torch.arange(M, dtype=torch.float32, device=dev)[None, :] + tu,
                        float(M)) * tn[:, None]
        check(torch.equal(torch.clamp(torch.searchsorted(tcdf, q), max=S - 1),
                          torch.clamp((tcdf[:, None, :] < q[:, :, None]).sum(-1), max=S - 1)),
              f"searchsorted disagrees with the compare-count ({label})")
        n_loop = loops[label]

        def loop():  # a tracker frame's or a BA step's placements, the placer made first
            placer = makers[timed]()
            for _ in range(n_loop):
                placer(*call_args[timed])

        if timed == "shared origin":
            # cdf rows, n_occ, t_cap, one origin, directions, jitter, one
            # grid cell per sample in; z, aid, valid, ray_mask out
            nbytes = R * S * 4 + R * 20 + 12 + R * M * 8 + R * M * 9 + R
        else:  # + each ray's row index and its own origin
            nbytes = R * S * 4 + R * 36 + R * M * 8 + R * M * 9 + R
        flops = R * M * (30 + 2 * int(np.ceil(np.log2(S))))
        call_ms, lib_ms = paired_median_ms(place, lambda: torch.searchsorted(tcdf, q))
        loop_ms, lib_loop_ms = paired_median_ms(
            loop, lambda: [torch.searchsorted(tcdf, q) for _ in range(n_loop)], n=PAIRED_RUNS // 4)
        p_ms = median_ms(lambda: raycast.place_samples_cdf_plain(ms, cfg, rc, *ins))
        what = "a tracker frame" if timed == "shared origin" else "a BA step"
        log(f"[K9] {label}, {timed} ({what}, {n_loop} iterations, R={R}): per call "
            f"{call_ms:.4f} ms against torch.searchsorted {lib_ms:.4f} ms; with the placer made "
            f"once per {n_loop} calls "
            f"{loop_ms / n_loop:.4f} ms against {lib_loop_ms / n_loop:.4f} ms, in turns "
            f"({'at or under' if loop_ms <= lib_loop_ms else 'over'} it); plain {p_ms:.4f} ms; "
            f"bound {bound(nbytes, flops)[0]:.5f} ms")
        # rays + t_cap in (one origin, or one a ray), one grid cell per
        # slot in range, cdf + n_occ out
        march_bytes = {k: r_bytes + 4 * in_range + C * S * 4 + C * 4
                       for k, r_bytes in (("per ray", C * 28), ("row stride 0", 12 + C * 16))}
        march_flops = 14 * in_range + 4 * C * S
        stride0_ms = median_ms(march_forms["CdfPlacer.march, origin row stride 0"][0])
        log(f"[K9a] {label}: CdfPlacer.march, origin row stride 0 (a tracker frame's march + "
            f"placer) {stride0_ms:.4f} ms, bound "
            f"{bound(march_bytes['row stride 0'], march_flops)[0]:.5f} ms")
        out[label] = dict(
            a=(median_ms(march_forms["march_occupancy"][0]),
               median_ms(lambda: raycast.march_occupancy_plain(ms, cfg, rc, ro, rd, rt)),
               march_bytes["per ray"], march_flops),
            b=(loop_ms / n_loop, p_ms, nbytes, flops, lib_loop_ms / n_loop), err=ez,
            dev_a=march_forms["march_occupancy"][0], dev_b=place,
            forms_a={f"{k}, {label}": (fn, KERNEL_FUNCTIONS["march_occupancy"])
                     for k, (fn, _) in march_forms.items() if k != "march_occupancy"})
        if label == "adam25":
            k9b_host_costs(ms, cfg, rc, pc, pn, o1, rd, rt, u, q)
            k9a_host_costs(ms, cfg, rc, ro1, rd, rt, M)
    a = out["adam25"]
    k_ms, p_ms, nbytes, flops, lib_ms = a["b"]
    return [record("march_occupancy", "grid_sampler.cu", "nerfloam_tpu/ops/raycast.py:65", 0.0,
                   *a["a"], dev=a["dev_a"],
                   forms={k: v for o_ in out.values() for k, v in o_["forms_a"].items()}),
            record("place_samples_cdf", "grid_sampler.cu", "nerfloam_tpu/ops/raycast.py:88",
                   max(o_["err"] for o_ in out.values()), k_ms, p_ms, nbytes, flops,
                   library_ms=lib_ms, dev=a["dev_b"])]


def mesh_kernels(slam, ms):
    """K10a and K10b over every surface voxel of the kernel phase's map, at
    res 2 (the shipped mesh_res) and res 4 (27 cells per voxel, through the
    cell table), with bf16 and f32 embeddings and 37 padding ids (-1)
    after them; the twins run in chunks of voxels. K10b in both forms: the
    padded one against its twin slot for slot, the compact one (the mesh
    path's) against the padded twin's ``tris[valid]`` (T equal, the
    triangles torch.equal), also on a chunk of padding ids alone (T = 0)
    and twice through one kept TetScratch, left all zero. Timed at res 2
    with the config's embedding type over the surface voxels alone, as
    the mesh path calls them."""
    dev, cfg = slam.device, slam.map_cfg
    dec, cdt = slam.state.decoder_params, getattr(torch, slam.compute_dtype)
    ids = vm.surface_voxel_ids(ms)
    B = ids.numel()
    ids_pad = torch.cat([ids, torch.full((37,), -1, dtype=torch.int32, device=dev)])
    Bp = ids_pad.numel()
    step = 32768
    scratch = marching.TetScratch()
    for dt in (torch.bfloat16, torch.float32):
        st = ms._replace(embeddings=ms.embeddings.to(dt))
        for res in (2, 4):
            cct = mesher._lattice_tables(res, dev)[2]
            ncell = cct.shape[0]
            n0 = mesher.mesh_lattice_launches
            e_f, e_p = mesher.mesh_lattice(st, cfg, ids_pad[:0], res)  # B = 0: no launch
            check(e_f.shape == (0, res ** 3, cfg.feat_dim) and e_p.shape == (0, res ** 3, 3)
                  and mesher.mesh_lattice_launches == n0, f"K10a at B = 0 (res {res}, {dt})")
            feats, pos = mesher.mesh_lattice(st, cfg, ids_pad, res)
            sdf = mesher.decoder_apply(dec, feats, cdt)[..., 0]
            tris, valid = marching.marching_tets_lattice(sdf, pos, cct, ids_pad)
            ctris, T = marching.marching_tets_compact(sdf, pos, cct, ids_pad, scratch=scratch)
            torch.cuda.synchronize()
            want = []
            for i in range(0, Bp, step):
                rf, rp = mesher.mesh_lattice_plain(st, cfg, ids_pad[i:i + step], res)
                check(torch.equal(feats[i:i + step], rf), f"K10a feats differ (res {res}, {dt})")
                check(torch.equal(pos[i:i + step], rp), f"K10a pos differ (res {res}, {dt})")
                rt, rv = marching.marching_tets_lattice_plain(sdf[i:i + step], rp, cct,
                                                              ids_pad[i:i + step])
                sl = slice(i * ncell, (i + step) * ncell)
                check(torch.equal(valid[sl], rv), f"K10b valid differs (res {res}, {dt})")
                check(torch.equal(tris[sl], rt), f"K10b tris differ (res {res}, {dt})")
                want.append(rt[rv])
            want = torch.cat(want)
            check(int(T) == want.shape[0] and torch.equal(ctris[:int(T)], want),
                  f"K10b compact: T {int(T)} and its triangles against the twin's tris[valid] "
                  f"({want.shape[0]}) (res {res}, {dt})")
            check(not bool(valid[B * ncell:].any()), f"K10b: a padding voxel emitted (res {res})")
            if res == 2:
                rows = st.embeddings[st.corner_idx[ids_pad.clamp(min=0).long()].clamp(min=0)
                                     .long()].float()
                check(torch.equal(feats, rows), f"K10a res 2 is not the corner rows ({dt})")
            log(f"[K10] res {res} {dt}: {B} surface voxels + {Bp - B} padding ids, {Bp * ncell} "
                f"cells, T = {int(T)} triangles; feats, pos, tris and valid equal to the twins, "
                "the compact form's T and triangles to the twin's tris[valid]")
            del feats, pos, sdf, tris, valid, ctris
    res, st = 2, ms
    S, F, esz = res ** 3, cfg.feat_dim, ms.embeddings.element_size()
    cct = mesher._lattice_tables(res, dev)[2]
    ncell = cct.shape[0]
    feats, pos = mesher.mesh_lattice(st, cfg, ids, res)
    sdf = mesher.decoder_apply(dec, feats, cdt)[..., 0]
    # a chunk with no triangle (padding ids alone), then the path's chunk twice
    none = torch.full((64,), -1, dtype=torch.int32, device=dev)
    e_tris, e_T = marching.marching_tets_compact(sdf[:64], pos[:64], cct, none, scratch=scratch)
    c1 = [x.clone() for x in marching.marching_tets_compact(sdf, pos, cct, ids, scratch=scratch)]
    c2 = marching.marching_tets_compact(sdf, pos, cct, ids, scratch=scratch)
    rt, rv = marching.marching_tets_lattice_plain(sdf, pos, cct, ids)
    torch.cuda.synchronize()
    T = int(c1[1])
    check(int(e_T) == 0, f"K10b compact: T = {int(e_T)} on a chunk of padding ids")
    check(int(c2[1]) == T == int(rv.sum()) and torch.equal(c1[0][:T], c2[0][:T])
          and torch.equal(c1[0][:T], rt[rv]), "K10b compact differs between two calls")
    check(not bool(scratch.state.any()), "K10b compact left its tile states or tickets set")
    log(f"[K10b] res 2: T = {T} triangles of {B} cells (the kernel phase's map); T = 0 on a "
        "chunk of padding ids; two calls through one kept TetScratch equal, its tile states and "
        "tickets all zero after each call")
    corners = int(torch.unique(st.corner_idx[ids.long()].clamp(min=0)).numel())
    ka = median_ms(lambda: mesher.mesh_lattice(st, cfg, ids, res))
    pa = median_ms(lambda: mesher.mesh_lattice_plain(st, cfg, ids, res))
    compact = partial(marching.marching_tets_compact, sdf, pos, cct, ids, scratch=scratch)
    padded = partial(marching.marching_tets_lattice, sdf, pos, cct, ids)
    kb = median_ms(compact)
    pb = median_ms(lambda: marching.marching_tets_compact_plain(sdf, pos, cct, ids))
    kb_pad = median_ms(padded)
    dec_ms = median_ms(lambda: mesher.decoder_apply(dec, feats, cdt))
    # sdf and pos per lattice sample, the ids and the cell table in; the
    # padded form 12 triangle slots and their mask per cell out, the
    # compact form T triangles and T
    in_bytes = B * S * 16 + B * 4 + ncell * 32
    pad_bound = bound(in_bytes + B * ncell * 12 * 37, B * ncell * 6 * 60)[0]
    log(f"[K10] res 2, {B} voxels: the decoder between K10a and K10b {dec_ms:.4f} ms; K10b "
        f"padded {kb_pad:.4f} ms, bound {pad_bound:.5f} ms")
    host = k10a_host_costs(st, cfg, ids, res)
    return [
        # ids, corner ids and coords per voxel and the distinct corner rows
        # in; feats and pos out
        record("mesh_lattice", "mesh.cu", "nerfloam_tpu/map/mesher.py:59", 0.0, ka, pa,
               B * (4 + 32 + 12) + corners * F * esz + B * S * (F + 3) * 4, B * S * (15 * F + 6),
               dev=partial(mesher.mesh_lattice, st, cfg, ids, res),
               forms={"mesh_lattice, res 4": (partial(mesher.mesh_lattice, st, cfg, ids, 4),
                                              KERNEL_FUNCTIONS["mesh_lattice"])},
               host_us=host),
        record("marching_tets", "mesh.cu", "nerfloam_tpu/ops/marching.py:63", 0.0, kb, pb,
               in_bytes + T * 36 + 4, B * ncell * 6 * 60, dev=compact,
               forms={"marching_tets, padded": (padded, KERNEL_FUNCTIONS["marching_tets"])},
               triangles=T, padded_ms=kb_pad, padded_bound_ms=pad_bound),
    ]


def s2s_kernels(slam, sp, frames, gen):
    """K11a on one frame's padded points (points_pad x the config's image)
    and K11b on the next frame's 2048 tracker rays at a pose 5 cm off, both
    against their twins, K11b alone and in the tracker's form (rotation
    given, adding into a system of the SDF term's size; timed in that
    form); K11b's library call is the einsum pair on J, w and r computed as
    the twin computes them."""
    dev = slam.device
    p0, _, v0 = frames[0].device_arrays(dev)
    pose0 = torch.as_tensor(frames[0].pose6, device=dev)
    k1 = s2s.build_prev_scan(sp, p0, v0, pose0)
    k2 = s2s.build_prev_scan(sp, p0, v0, pose0)
    ref = s2s.build_prev_scan_plain(sp, p0, v0, pose0)
    torch.cuda.synchronize()
    e11a = 0.0
    for nm in s2s.PrevScan._fields:
        check(torch.equal(getattr(k1, nm), getattr(k2, nm)), f"K11a {nm} differs between two calls")
        check(torch.equal(getattr(k1, nm), getattr(ref, nm)), f"K11a {nm} differs from the twin")
    P, total = p0.shape[0], sp.n_elev * sp.n_az
    n_ok = int((v0 & (torch.linalg.norm(p0, dim=-1) > sp.min_depth)
                & (torch.linalg.norm(p0, dim=-1) < sp.max_depth)).sum())
    log(f"[K11a] {P} points ({n_ok} in range) into {sp.n_elev} x {sp.n_az}: "
        f"{int(ref.pix_valid.sum())} valid pixels, elevation span "
        f"[{float(ref.elev_min):.4f}, {float(ref.elev_max):.4f}] rad; every output equal to the "
        "twin and bit-identical across two calls")
    ka = median_ms(lambda: s2s.build_prev_scan(sp, p0, v0, pose0))
    pa = median_ms(lambda: s2s.build_prev_scan_plain(sp, p0, v0, pose0), n=5)

    p1, _, v1 = frames[1].device_arrays(dev)
    idx, rvalid = sample_ray_indices(v1, slam.tp.n_rays, gen)
    pts = p1[idx]
    pose1 = torch.as_tensor(frames[1].pose6, device=dev) + torch.tensor(
        [0.05, -0.03, 0.01, 0.0, 0.002, -0.003], device=dev)
    a = (sp, ref, pose1, pts, rvalid)
    R1 = se3.pose_rotation(pose1)
    # the tracker's form: its rotation and K3's sums, taken in place (a
    # system of the SDF term's magnitude)
    acc0 = (torch.randn((6, 6), generator=gen, device=dev) * 1e4,
            torch.randn((6,), generator=gen, device=dev) * 1e3, torch.tensor(2e3, device=dev))
    forms = {"alone": lambda fn: fn(*a),
             "accumulating": lambda fn: fn(*a, R1, tuple(x.clone() for x in acc0))}
    e11b, outs = 0.0, {}
    for form, run in forms.items():
        kH, kb, kl = run(s2s.s2s_system)
        kH2, kb2, kl2 = run(s2s.s2s_system)
        rH, rb, rl = run(s2s.s2s_system_plain)
        torch.cuda.synchronize()
        check(torch.equal(kH, kH2) and torch.equal(kb, kb2) and torch.equal(kl, kl2),
              f"K11b differs between two runs ({form})")
        for nm, k, r in (("H", kH, rH), ("b", kb, rb), ("loss", kl, rl)):
            rel = max_abs(k, r) / max(float(r.abs().max()), 1e-30)
            check(rel <= 1e-5, f"K11b {nm} rel error {rel} ({form})")
            e11b = max(e11b, max_abs(k, r))
            log(f"[K11b] {form} {nm}: rel err {rel:.3g} (max |{nm}| {float(r.abs().max()):.4g})")
        outs[form] = (kH, kb, kl)
    for x, y, k in zip(acc0, outs["alone"], outs["accumulating"]):
        check(torch.equal(k, x + y), "K11b's accumulating form is not one add on its sums")
    p_w, t, n, r, w = s2s._associate(*a)
    n_assoc = int((w > 0).sum())
    check(n_assoc >= 64, f"K11b: only {n_assoc} associated rays")
    J = torch.cat([n, s2s._cross(p_w - t, n)], -1)
    Jw = J * w[:, None]
    acc = tuple(x.clone() for x in acc0)  # the timed calls add into it
    kb_ms, lib_ms = paired_median_ms(
        lambda: s2s.s2s_system(*a, R1, acc),
        lambda: (torch.einsum("ni,nj->ij", Jw, J), torch.einsum("ni,n->i", Jw, r)))
    direct_ms = median_ms(lambda: s2s.s2s_system(*a))
    pb_ms = median_ms(lambda: s2s.s2s_system_plain(*a, R1, acc))
    N = pts.shape[0]
    log(f"[K11b] {N} rays: {n_assoc} associated (weight > 0); the tracker's form (rotation "
        f"given, accumulating) {kb_ms:.4f} ms against the einsum pair {lib_ms:.4f} ms, in turns "
        f"({'at or under' if kb_ms <= lib_ms else 'over'} it); called alone (rotation built, "
        f"sums allocated) {direct_ms:.4f} ms")
    return [
        # points + valid and the pose in; q_w, n_w, validity, depth per
        # pixel and the span out
        record("build_prev_scan", "scan2scan.cu", "nerfloam_tpu/core/scan2scan.py:79", e11a, ka, pa,
               P * 13 + 48 + total * 29 + 8, P * 60 + total * 90,
               dev=partial(s2s.build_prev_scan, sp, p0, v0, pose0),
               _rotation=partial(se3.pose_rotation, pose0)),
        # rays + valid, two poses and the span in, one pixel (q, n, validity,
        # depth) per ray in; the caller's H, b, loss in and out
        record("s2s_system", "scan2scan.cu", "nerfloam_tpu/core/scan2scan.py:158", e11b, kb_ms,
               pb_ms, N * 13 + 96 + 8 + N * 29 + 172 + 172, N * 160, lib_ms,
               dev=partial(s2s.s2s_system, *a, R1, acc)),
    ]


def ulp_gap(got, ref):
    """(the largest |got - ref| of the rotation half (..., 3:) in ulp of each
    pose's largest entry, the same in ulp of the rotation's largest entry,
    the share of poses bit-equal); (N, 6) tensors."""
    g, r = got.cpu().double().numpy(), ref.cpu().double().numpy()
    d = np.abs(g - r)[:, 3:]
    pose_ulp = np.spacing(np.abs(r).max(1, keepdims=True).astype(np.float32)).astype(np.float64)
    rot_ulp = np.spacing(np.abs(r[:, 3:]).max(1, keepdims=True).astype(np.float32)).astype(
        np.float64)
    return float((d / pose_ulp).max()), float((d / rot_ulp).max()), float((g == r).all(1).mean())


def lm_steps(n, seed=0):
    """n seeded (pose, solve solution) pairs like a GN iteration's: poses
    10 m from the origin, the first half at small angles (exp_so3's series
    branch for the pose and the step), the rest at rotations of 0.8 rad
    and steps of 0.05 rad; translation steps of 1 mm to 1 m."""
    rng = np.random.default_rng(seed)
    small = (np.arange(n) < n // 2)[:, None]
    pose = np.concatenate([rng.normal(0, 10, (n, 3)), np.where(
        small, rng.normal(0, 3e-5, (n, 3)), rng.normal(0, 0.8, (n, 3)))], 1)
    step = np.concatenate([rng.normal(0, 0.3, (n, 3)) * np.exp(rng.uniform(-6, 1, (n, 1))),
                           np.where(small, rng.normal(0, 3e-5, (n, 3)),
                                    rng.normal(0, 0.05, (n, 3)))], 1)
    return (torch.as_tensor(pose.astype(np.float32)), torch.as_tensor(step.astype(np.float32)))


def gn_frame_calls(slam, ms, frame, iterations):
    """Calls of se3.exp_so3 and se3.log_so3 and norm3 launches in one GN
    tracker frame (the quality config's, on ``ms``) at ``iterations``."""
    calls = Counter()
    wrapped = {}
    for nm in ("exp_so3", "log_so3"):
        fn = wrapped[nm] = getattr(se3, nm)
        setattr(se3, nm, partial(lambda fn, nm, *a, **k: calls.update([nm]) or fn(*a, **k),
                                 fn, nm))
    n0 = ieee.norm3_launches
    try:
        p, c, v = frame.device_arrays(slam.device)
        gen = torch.Generator(device=slam.device)
        gen.manual_seed(5)
        tr.track_frame_gn(ms, slam.map_cfg, slam.rc_track,
                          slam.tp._replace(num_iterations=iterations),
                          slam.state.decoder_params, torch.as_tensor(frame.pose6,
                                                                     device=slam.device),
                          p, c, v, gen)
        torch.cuda.synchronize()
    finally:
        for nm, fn in wrapped.items():
            setattr(se3, nm, fn)
    return calls["exp_so3"], calls["log_so3"], ieee.norm3_launches - n0


def tracker_step_kernels(slam, ms, frames, gen, R_ba):
    """[ray_prep] at the tracker's rays (2048 of a frame's points) and at
    BA's superset (``R_ba`` rays of each of 2 frames, (2, R_ba, 3)),
    torch.equal to its twin on the card and on the CPU; [lm_step] on
    10,000 seeded steps (half at small angles) in one batched launch,
    against its twin on the card and on the CPU (batched, and one step a
    call on every fifth, the tracker's form): the translation and the
    small-angle half (pose and R) torch.equal; the rest's rotation within 4
    ulp of each pose's largest entry and 8 of the rotation's, its R within
    8 ulp of 1 of the twin's; R the twin's exp_so3 of the kernel's own pose
    (small-angle half torch.equal, the rest within 4 ulp of 1); the largest
    gaps and the share of poses bit-equal printed; the tracker's one-step
    form equal to the batch's row; and a GN tracker
    frame at 2 and at 16 iterations making the same calls of exp_so3 and
    log_so3 and the same norm3 launches (none inside the loop after its
    first rotation)."""
    dev = slam.device
    tp = slam.tp
    p, c, v = frames[0].device_arrays(dev)
    idx, _ = sample_ray_indices(v, tp.n_rays, gen)
    pts, pcos = p[idx], c[idx]
    p1, c1, v1 = frames[1].device_arrays(dev)
    sidx = torch.stack([sample_ray_indices(vv, R_ba, gen)[0] for vv in (v, v1)])
    pw = torch.stack([p, p1])[torch.arange(2, device=dev)[:, None], sidx]
    cw = torch.stack([c, c1])[torch.arange(2, device=dev)[:, None], sidx]
    cases = {"tracker": (pts, pcos, tp.truncation, tp.max_depth),
             "BA superset": (pw, cw, slam.bp_current.truncation, slam.bp_current.max_depth)}
    err = 0.0
    for label, (a, b, trunc, md) in cases.items():
        ker = tr.ray_prep(a, b, trunc, md)
        again = tr.ray_prep(a, b, trunc, md)
        twin = tr.ray_prep_plain(a, b, trunc, md)
        cpu = tr.ray_prep_plain(a.cpu(), b.cpu(), trunc, md)
        torch.cuda.synchronize()
        for nm, k, k2, t, t_cpu in zip(tr.RayPrep._fields, ker, again, twin, cpu):
            check(torch.equal(k, t) and torch.equal(k.cpu(), t_cpu) and torch.equal(k, k2),
                  f"ray_prep {nm} differs from its twin on the card or the CPU ({label})")
            err = max(err, max_abs(k.float(), t.float()))
        log(f"[ray_prep] {label} {tuple(b.shape)}: dirs, t_cap, d_meas, depth_ok and dnorm "
            "torch.equal to the twin on the card and on the CPU, and between two calls")
    n = pcos.numel()
    k_ms = median_ms(partial(tr.ray_prep, *cases["tracker"]))
    p_ms = median_ms(partial(tr.ray_prep_plain, *cases["tracker"]))
    ba_ms = median_ms(partial(tr.ray_prep, *cases["BA superset"]))
    log(f"[ray_prep] BA superset {tuple(cw.shape)}: kernel {ba_ms:.4f} ms")
    rec_ray = record("ray_prep", "ray_prep.cu", "nerfloam_tpu/core/tracking.py:156-160 (dirs, "
                     "t_cap_for, d_meas, depth_ok)", err, k_ms, p_ms, 41 * n, 30 * n,
                     dev=partial(tr.ray_prep, *cases["tracker"]),
                     forms={"ray_prep, BA superset": (partial(tr.ray_prep, *cases["BA superset"]),
                                                      KERNEL_FUNCTIONS["ray_prep"])})

    P, S = lm_steps(10000)
    kp, kR = tr.lm_step(P.to(dev), S.to(dev))
    tp_dev, tR_dev = tr.lm_step_plain(P.to(dev), S.to(dev))
    tp_cpu, tR_cpu = tr.lm_step_plain(P, S)
    one = [tr.lm_step_plain(P[i], S[i]) for i in range(0, len(P), 5)]
    one_p, one_R = torch.stack([x for x, _ in one]), torch.stack([r for _, r in one])
    # the twin's rotation of the kernel's own poses: R's formula alone
    own = {"on the card": se3.pose_rotation(kp), "on the CPU": se3.pose_rotation(kp.cpu())}
    k1p, k1R = tr.lm_step(P[7].to(dev), S[7].to(dev))
    torch.cuda.synchronize()
    check(torch.equal(k1p, kp[7]) and torch.equal(k1R, kR[7]),
          "lm_step's one-step form differs from the batch's row")
    kp, kR = kp.cpu(), kR.cpu()
    half, one_ulp = len(P) // 2, float(np.spacing(np.float32(1.0)))
    rot_err = 0.0
    for label, ref, ref_R, rows in (
            ("the twin on the card", tp_dev, tR_dev, slice(None)),
            ("the twin on the CPU, batched", tp_cpu, tR_cpu, slice(None)),
            ("the twin on the CPU, one step a call", one_p, one_R, slice(None, None, 5))):
        got, got_R, ref, ref_R = kp[rows], kR[rows], ref.cpu(), ref_R.cpu()
        sub = len(got) * half // len(P)
        check(torch.equal(got[:, :3], ref[:, :3]), f"lm_step's translation differs from {label}")
        check(torch.equal(got[:sub], ref[:sub]) and torch.equal(got_R[:sub], ref_R[:sub]),
              f"lm_step's small-angle half (no sine) differs from {label}")
        worst, worst_rot, share = ulp_gap(got, ref)
        r_ulp = float((got_R - ref_R).abs().max()) / one_ulp
        rot_err = max(rot_err, r_ulp * one_ulp)
        log(f"[lm_step] {len(got)} steps against {label}: translation torch.equal, the "
            f"small-angle half pose and R torch.equal; rotation within {worst:.4g} ulp of each "
            f"pose's largest entry ({worst_rot:.4g} of the rotation's); poses bit-equal "
            f"{share:.4f}; R within {r_ulp:.4g} ulp of 1 of the twin's")
        # the kernel's sine, cosine and atan2 are the host's (native/trig.h):
        # 0-1 ulp expected, where CUDA's sinf and atan2f read up to 6 on an
        # H100; the limit stays 4. A transposed R, or the old pose's, is off
        # by at least the step's angle, ~5e-5 rad (~400 ulp of 1) in the
        # small-angle half and 0.05 rad in the rest
        check(worst <= 4.0 and worst_rot <= 8.0,
              f"lm_step's rotation {worst} ulp of the pose ({worst_rot} of the rotation) "
              f"from {label}")
        check(r_ulp <= 8.0, f"lm_step's R {r_ulp} ulp of 1 from {label}")
    for label, R_own in own.items():
        R_own = R_own.cpu()
        r_ulp = float((kR - R_own).abs().max()) / one_ulp
        log(f"[lm_step] its R against se3.pose_rotation of its own pose {label}: small-angle "
            f"half torch.equal, the rest within {r_ulp:.4g} ulp of 1")
        check(torch.equal(kR[:half], R_own[:half]) and r_ulp <= 4.0,
              f"lm_step's R is not exp_so3 of its pose {label} ({r_ulp} ulp of 1)")
    pose1, step1 = P[7].to(dev), S[7].to(dev)
    k_ms = median_ms(partial(tr.lm_step, pose1, step1))
    p_ms = median_ms(partial(tr.lm_step_plain, pose1, step1))
    calls = {it: gn_frame_calls(slam, ms, frames[1], it) for it in (2, 16)}
    log("[lm_step] a GN tracker frame's exp_so3 calls, log_so3 calls and norm3 launches: "
        + ", ".join(f"{it} iterations {c_}" for it, c_ in calls.items()))
    check(calls[2] == calls[16], "exp_so3, log_so3 or norm3 launch inside the GN loop")
    # 48 B in, 60 B out; ~600 f32 operations
    rec_lm = record("lm_step", "lm_step.cu", "nerfloam_tpu/core/tracking.py:326-334 (trust "
                    "region, exp_so3, compose, log_so3)", max(max_abs(kp, tp_dev.cpu()), rot_err),
                    k_ms, p_ms, 108, 600,
                    dev=partial(tr.lm_step, pose1, step1))
    return [rec_ray, rec_lm, lm_tail_phase(gen, tp.n_rays)]


def gn_systems(n, gen, rows=256):
    """n seeded (pose, H, b) on the card as the GN tracker meets them: H =
    sum w J J^T and b = sum w J r over ``rows`` samples, J = [g, q x g]
    with lever arms q of 2-40 m, every fourth system's gradients on one
    plane (ill-conditioned); the poses 10 m out, the first half in
    exp_so3's series branch, the rest at 0.8 rad."""
    dev = gen.device
    g = torch.randn((n, rows, 3), generator=gen, device=dev)
    plane = torch.tensor([0.02, 0.01, 1.0], device=dev) + 1e-3 * torch.randn(
        (n, rows, 3), generator=gen, device=dev)
    g = torch.where((torch.arange(n, device=dev) % 4 == 1)[:, None, None], plane, g)
    g = g / g.norm(dim=-1, keepdim=True)
    q = torch.randn((n, rows, 3), generator=gen, device=dev) * (
        2 + 38 * torch.rand((n, rows, 1), generator=gen, device=dev))
    J = torch.cat([g, torch.linalg.cross(q, g, dim=-1)], -1)
    w = 1e3 * torch.rand((n, rows, 1), generator=gen, device=dev) * (
        torch.rand((n, rows, 1), generator=gen, device=dev) < 0.8)
    r = 0.05 * torch.randn((n, rows), generator=gen, device=dev)
    H = torch.einsum("nri,nrj->nij", J * w, J).contiguous()
    b = torch.einsum("nri,nr->ni", J * w, r).contiguous()
    small = (torch.arange(n, device=dev) < n // 2)[:, None]
    rot = torch.where(small, 3e-5 * torch.randn((n, 3), generator=gen, device=dev),
                      0.8 * torch.randn((n, 3), generator=gen, device=dev))
    return torch.cat([10 * torch.randn((n, 3), generator=gen, device=dev), rot], 1), H, b


def lm_tail_phase(gen, n_rays, n_systems=10000):
    """[lm_step], kernel A: tracking.lm_tail (csrc/lm_step.cu: the damping,
    the solve, the pose step and the next iteration's rays in one launch)
    torch.equal to lm_tail_plain on the card and on the CPU on
    ``n_systems`` seeded systems (a grid row each, 8 rays a system; each
    row equal to the one-system form) and at the tracker's ``n_rays`` rays,
    on a system of 2048 x 72 samples; timed in turns against the parent's
    chain (parent_gn_tail), whose launches a call are profiled with the
    record's forms. Returns its record."""
    dev = gen.device
    pose, H, b = gn_systems(n_systems, gen)
    dirs = unit_dirs((n_systems, 8), gen)
    got = tr.lm_tail(pose, H, b, 1e-2, dirs)
    twin = tr.lm_tail_plain(pose, H, b, 1e-2, dirs)
    cpu = tr.lm_tail_plain(pose.cpu(), H.cpu(), b.cpu(), 1e-2, dirs.cpu())
    torch.cuda.synchronize()
    for nm, k, t, c in zip(("pose", "R", "wdirs"), got, twin, cpu):
        check(torch.equal(k, t) and torch.equal(k.cpu(), c),
              f"[lm_step] lm_tail's {nm} differs from lm_tail_plain on the card or the CPU")
    for i in (0, n_systems // 2 + 1, n_systems - 1):
        one = tr.lm_tail(pose[i], H[i], b[i], 1e-2, dirs[i])
        check(all(torch.equal(a, full[i]) for a, full in zip(one, got)),
              "[lm_step] lm_tail's one-system form differs from the batch's row")
    finite = float(torch.isfinite(got[0]).all(-1).float().mean())
    H1, b1 = gn_test_system(gen)
    p1, d1 = pose[n_systems - 1].clone(), unit_dirs((n_rays,), gen)
    one = tr.lm_tail(p1, H1, b1, 1e-2, d1)
    again = tr.lm_tail(p1, H1, b1, 1e-2, d1)
    ref = tr.lm_tail_plain(p1, H1, b1, 1e-2, d1)
    ref_cpu = tr.lm_tail_plain(p1.cpu(), H1.cpu(), b1.cpu(), 1e-2, d1.cpu())
    parent = parent_gn_tail(p1, H1, b1, 1e-2, d1)
    torch.cuda.synchronize()
    for nm, k, k2, t, c in zip(("pose", "R", "wdirs"), one, again, ref, ref_cpu):
        check(torch.equal(k, t) and torch.equal(k.cpu(), c) and torch.equal(k, k2),
              f"[lm_step] lm_tail's {nm} at {n_rays} rays differs from its twin or between calls")
    log(f"[lm_step] lm_tail (csrc/lm_step.cu, kernel A): pose, R and wdirs torch.equal to "
        f"lm_tail_plain on the card and on the CPU on {n_systems} seeded systems ({finite:.4f} "
        f"of poses finite) and at the tracker's {n_rays} rays; the parent's chain (cuSOLVER, "
        f"lm_step, cuBLAS) on the tracker's system lands {max_abs(one[0], parent[0]):.3g} from "
        f"it in the pose")
    call = partial(tr.lm_tail, p1, H1, b1, 1e-2, d1)
    chain = partial(parent_gn_tail, p1, H1, b1, 1e-2, d1)
    k_ms, c_ms = paired_median_ms(call, chain)
    p_ms = median_ms(partial(tr.lm_tail_plain, p1, H1, b1, 1e-2, d1))
    log(f"[lm_step] a GN iteration's tail at {n_rays} rays, in turns: lm_tail {k_ms:.4f} ms, the "
        f"parent's chain {c_ms:.4f} ms; host us (card idle before each): lm_tail "
        f"{host_us_idle(call):.2f}, the parent's chain {host_us_idle(chain):.2f}")
    # in: H, b, lam, the pose, the rays; out: the pose, R, the rays. ~1,500
    # operations of the solve and the step, 15 a ray
    return record("lm_tail", "lm_step.cu", "nerfloam_tpu/core/tracking.py:326-334 and :249 "
                  "(the damped solve, the LM step and the next iteration's rotate_dirs, fused "
                  "into the fori_loop body by XLA; no TPU kernel)", 0.0, k_ms, p_ms,
                  24 * n_rays + 256, 1500 + 15 * n_rays, dev=call,
                  forms={"lm_tail, 10,000 systems": (
                      partial(tr.lm_tail, pose, H, b, 1e-2, dirs), KERNEL_FUNCTIONS["lm_tail"]),
                      "lm_tail, the parent's chain": (chain, KERNEL_FUNCTIONS["lm_step"])},
                  parent_chain_ms=c_ms)


def pose_rays_phase(slam, gen):
    """[pose_rays], kernel B: se3.pose_rays (csrc/pose_rays.cu, one launch
    each way) at BA's shapes (the current frame, W = 1, and the window of
    W frames, 2048 rays a frame; the superset's 2 x 2048 forward) and the
    Adam tracker's (one pose, 2048 rays), the poses half in exp_so3's series
    branch: origins, directions and R torch.equal to pose_rays_plain on the
    card and on the CPU; the poses' gradient from seeded cotangents within
    EXP_SO3_GRAD_TOL of each pose's largest entry of autograd through the
    twin on the CPU, the same bits on a second call. Timed in turns against
    the parent's chain (parent_pose_rays, forward and backward), whose
    launches a call are profiled with the record's forms. Returns its
    record."""
    dev = slam.device
    N, W = slam.bp_current.n_rays, slam.window_size
    err, worst, cases = 0.0, 0.0, {}
    for label, w_, n_, grad in (("current frame", 1, N, True), (f"window of {W}", W, N, True),
                                ("BA superset", W, 2 * N, False),
                                ("Adam tracker", 0, slam.tp.n_rays, True)):
        k = max(w_, 1)
        rot = torch.randn((k, 3), generator=gen, device=dev) * torch.where(
            torch.arange(k, device=dev) % 2 == 0, 3e-5, 0.5)[:, None]
        poses = torch.cat([10 * torch.randn((k, 3), generator=gen, device=dev), rot], 1)
        dirs = unit_dirs((k, n_), gen)
        if w_ == 0:
            poses, dirs = poses[0].clone(), dirs[0].clone()
        ok = se3.pose_rays(poses, dirs, with_R=True)
        od = se3.pose_rays_plain(poses, dirs, with_R=True)
        oc = se3.pose_rays_plain(poses.cpu(), dirs.cpu(), with_R=True)
        torch.cuda.synchronize()
        for nm, a, t, c in zip(("origins", "wdirs", "R"), ok, od, oc):
            check(torch.equal(a, t) and torch.equal(a.cpu(), c),
                  f"[pose_rays] {label}: {nm} differs from pose_rays_plain on the card or the CPU")
        if not grad:
            cases[label] = (poses, dirs, None, None)
            continue
        go, gd = (torch.randn(ok[0].shape, generator=gen, device=dev) for _ in range(2))
        gk = rays_fwd_bwd(se3.pose_rays, poses, dirs, go, gd)
        gk2 = rays_fwd_bwd(se3.pose_rays, poses, dirs, go, gd)
        gc = rays_fwd_bwd(se3.pose_rays_plain, poses.cpu(), dirs.cpu(), go.cpu(), gd.cpu())
        check(torch.equal(gk, gk2), f"[pose_rays] {label}: two backward calls differ")
        scale = gc.reshape(-1, 6).abs().amax(-1, keepdim=True).clamp_min(1e-30)
        rel = float(((gk.cpu() - gc).reshape(-1, 6).abs() / scale).max())
        err, worst = max(err, max_abs(gk.cpu(), gc)), max(worst, rel)
        check(rel <= EXP_SO3_GRAD_TOL, f"[pose_rays] {label}: the poses' gradient {rel:.3g} of "
              f"its largest entry off the twin's (limit {EXP_SO3_GRAD_TOL})")
        cases[label] = (poses, dirs, go, gd)
    log(f"[pose_rays] csrc/pose_rays.cu, kernel B: origins, wdirs and R torch.equal to "
        f"pose_rays_plain on the card and on the CPU at BA's current frame, window of {W} and "
        f"superset and the Adam tracker's rays; the poses' gradient within {worst:.3g} of each "
        f"pose's largest entry (limit {EXP_SO3_GRAD_TOL}), the same bits between calls")
    timed = {}
    for label in ("current frame", f"window of {W}", "Adam tracker"):
        poses, dirs, go, gd = cases[label]
        kern = partial(rays_fwd_bwd, se3.pose_rays, poses, dirs, go, gd)
        chain = partial(rays_fwd_bwd, parent_pose_rays, poses, dirs, go, gd)
        k_ms, c_ms = paired_median_ms(kern, chain)
        kf_ms, cf_ms = paired_median_ms(partial(se3.pose_rays, poses, dirs),
                                        partial(parent_pose_rays, poses, dirs))
        timed[label] = (k_ms, c_ms, kern, chain)
        log(f"[pose_rays] {label} {tuple(dirs.shape)}, forward and backward (autograd.grad), in "
            f"turns: pose_rays {k_ms:.4f} ms, the parent's chain {c_ms:.4f} ms; forward alone "
            f"{kf_ms:.4f} and {cf_ms:.4f} ms; host us (card idle before each): pose_rays "
            f"{host_us_idle(kern):.2f}, the parent's chain {host_us_idle(chain):.2f}")
    poses, dirs, go, gd = cases[f"window of {W}"]
    k_ms, c_ms, kern, chain = timed[f"window of {W}"]
    p_ms = median_ms(partial(rays_fwd_bwd, se3.pose_rays_plain, poses, dirs, go, gd))
    n = dirs.shape[0] * dirs.shape[1]
    fw, both = KERNEL_FUNCTIONS["pose_rays"], KERNEL_FUNCTIONS["pose_rays"] + KERNEL_FUNCTIONS[
        "pose_rays_bwd"]
    forms = {"pose_rays, backward": (partial(se3.pose_rays_bwd, poses, dirs, go, gd),
                                     KERNEL_FUNCTIONS["pose_rays_bwd"]),
             f"pose_rays, window of {W}, forward and backward": (kern, both),
             f"pose_rays, window of {W}, the parent's chain": (
                 chain, KERNEL_FUNCTIONS["exp_so3"] + KERNEL_FUNCTIONS["exp_so3_bwd"])}
    for label in ("current frame", "Adam tracker"):
        forms[f"pose_rays, {label}, the parent's chain"] = (
            timed[label][3], KERNEL_FUNCTIONS["exp_so3"] + KERNEL_FUNCTIONS["exp_so3_bwd"])
    a = cases["Adam tracker"]
    forms["pose_rays, Adam tracker"] = (partial(se3.pose_rays, a[0], a[1]), fw)
    forms["pose_rays, Adam tracker, forward and backward"] = (timed["Adam tracker"][2], both)
    # forward: the poses and dirs read, origins and wdirs written (12 B a ray
    # each way); backward: dirs and both cotangents read; ~15 operations a ray
    # forward and ~24 backward
    return record("pose_rays", "pose_rays.cu", "nerfloam_tpu/core/ba.py:253-256 "
                  "(vmap(se3.rotate_dirs) and the translation broadcast) and "
                  "nerfloam_tpu/core/tracking.py:249, 436 (se3.rotate_dirs; XLA fusions, no TPU "
                  "kernel)", err, k_ms, p_ms, 72 * n + 96 * dirs.shape[0],
                  39 * n + 1200 * dirs.shape[0], dev=partial(se3.pose_rays, poses, dirs),
                  forms=forms, parent_chain_ms=c_ms)


def _equal_outputs(label, got, twin, cpu):
    """Check every output of a draw kernel torch.equal to its twin on the
    card and on the CPU; return the largest gap (0)."""
    for nm, k, d, h in zip(type(got)._fields, got, twin, cpu):
        check(torch.equal(k, d) and torch.equal(k.cpu(), h),
              f"[ray_draw] {label}: {nm} differs from its twin on the card or the CPU")
    return 0.0


def ray_draw_phase(slam, frames, gen):
    """[ray_draw], kernel A: a ray draw in its kernels (csrc/draw_keys.cu,
    csrc/ray_prep.cu). The keys (draw_keys) torch.equal to the eager chain
    on the card on 2^24 uniforms of the card's generator and its edges;
    at the quality shapes (a frame's 65,536 points, the tracker's 2048
    rays, every column and a dp rank's half; BA's superset of 2 x 2048 rays
    of the current frame and of a window of 4, its picks of 2048 a frame
    with a frame mask, its draw without one) every output of ray_draw,
    ray_superset and ray_pick torch.equal to its twin on the card and on
    the CPU. Each site is timed in turns against the parent's chain
    (chip_smoke.parent_*), with its host us. Returns the four records."""
    dev = slam.device
    tp, bp = slam.tp, slam.bp_current
    trunc, md = tp.truncation, tp.max_depth
    u = torch.rand((1 << 24,), generator=gen, device=dev)
    u[:6] = torch.tensor([0.0, _TINY, 1e-30, 0.5, 0.99999994, 0.9999999], device=dev)
    valid = torch.rand((1 << 24,), generator=gen, device=dev) < 0.85
    keys, chain = sampling.draw_keys(u, valid), sampling.draw_keys_plain(u, valid)
    differ = int((keys.view(torch.int32) != chain.view(torch.int32)).sum())
    log(f"[ray_draw] draw_keys on 2^24 uniforms: {differ} keys differ in their bits from the "
        "card's eager chain (clamp, log, neg, log, neg, where, add)")
    check(differ == 0, f"[ray_draw] draw_keys differs from the eager chain on {differ} keys")
    pts = torch.stack([f.device_arrays(dev)[0] for f in frames])
    cos = torch.stack([f.device_arrays(dev)[1] for f in frames])
    val = torch.stack([f.device_arrays(dev)[2] for f in frames])
    W, P = pts.shape[:2]
    active = torch.arange(W, device=dev) != 2
    sdf_bias = torch.tensor([0.012, -0.031], device=dev)
    idx = draw_indices(val[0], tp.n_rays, gen)
    for cols in (slice(None), slice(tp.n_rays // 2, tp.n_rays)):
        args = (idx, cols, pts[0], cos[0], val[0], trunc, md, sdf_bias)
        cpu_args = (idx.cpu(), cols, pts[0].cpu(), cos[0].cpu(), val[0].cpu(), trunc, md,
                    sdf_bias.cpu())
        _equal_outputs(f"tracker {cols}", tr.ray_draw(*args), tr.ray_draw_plain(*args),
                       tr.ray_draw_plain(*cpu_args))
    K = 2 * bp.n_rays
    sups = {}
    for Wn in (1, W):
        sidx = draw_indices(val[:Wn], K, gen)
        a = (sidx, pts[:Wn], cos[:Wn], val[:Wn], bp.truncation, bp.max_depth)
        sups[Wn] = tr.ray_superset(*a)
        _equal_outputs(f"superset W={Wn}", sups[Wn], tr.ray_superset_plain(*a),
                       tr.ray_superset_plain(*(x.cpu() if isinstance(x, torch.Tensor) else x
                                               for x in a)))
        ridx = torch.randint(0, K, (Wn, bp.n_rays), generator=gen, device=dev)
        for cols in (slice(None), slice(bp.n_rays // 2, bp.n_rays)):
            cpu_sup = tr.Superset(*(x.cpu() for x in sups[Wn]))
            _equal_outputs(f"pick W={Wn} {cols}", tr.ray_pick(ridx, cols, sups[Wn], active[:Wn]),
                           tr.ray_pick_plain(ridx, cols, sups[Wn], active[:Wn]),
                           tr.ray_pick_plain(ridx.cpu(), cols, cpu_sup, active[:Wn].cpu()))
    eidx = draw_indices(val, bp.n_rays, gen)
    a = (eidx, slice(None), pts, cos, val, bp.truncation, bp.max_depth, None, active)
    _equal_outputs("BA without a superset", tr.ray_draw(*a), tr.ray_draw_plain(*a),
                   tr.ray_draw_plain(*(x.cpu() if isinstance(x, torch.Tensor) else x for x in a)))
    log(f"[ray_draw] ray_draw, ray_superset and ray_pick: every output torch.equal to its twin "
        f"on the card and on the CPU: the tracker's {tp.n_rays} rays of {P} points (every column "
        f"and a dp rank's half, a device sdf_bias), BA's superset of {K} rays a frame (W = 1 and "
        f"{W}), its picks of {bp.n_rays} a frame with a frame mask (every column and a half), "
        f"and its draw without one (W = {W})")
    # the sites in turns against the parent's chains, at the main path's shapes
    cases = draw_warmstart_cases(gen, window=W, trunc=trunc, max_depth=md)
    timed = {}
    for label, (chain, kern, _) in cases.items():
        if label == "deferred warm start":
            continue
        k_ms, c_ms = paired_median_ms(kern, chain)
        timed[label] = (k_ms, c_ms, kern, chain)
        log(f"[ray_draw] {label}, in turns: the kernels {k_ms:.4f} ms, the parent's chain "
            f"{c_ms:.4f} ms; host us (card idle before each): the kernels "
            f"{host_us_idle(kern):.2f}, the parent's chain {host_us_idle(chain):.2f}")
    u0 = torch.rand(val[0].shape, generator=gen, device=dev)
    key_args = (u0, val[0])
    k_ms, p_ms = median_ms(partial(sampling.draw_keys, *key_args)), median_ms(
        partial(sampling.draw_keys_plain, *key_args))
    nk = u0.numel()
    forms_keys = {"draw_keys, the parent's chain": (partial(sampling.draw_keys_plain, *key_args),
                                                    ())}
    # u and valid read (5 B), a key written (4 B); two logs (~20 operations each)
    rec_keys = record("draw_keys", "draw_keys.cu", "nerfloam_tpu/ops/sampling.py:23-25 (the "
                      "mask's logits and jax.random.gumbel's -log(-log(u)); an XLA fusion, no "
                      "TPU kernel)", 0.0, k_ms, p_ms, 9 * nk, 45 * nk,
                      dev=partial(sampling.draw_keys, *key_args), forms=forms_keys)
    targs = (idx, slice(None), pts[0], cos[0], val[0], trunc, md, sdf_bias)
    eargs = (eidx, slice(None), pts, cos, val, bp.truncation, bp.max_depth, None, active)
    k_ms, p_ms = median_ms(partial(tr.ray_draw, *targs)), median_ms(
        partial(tr.ray_draw_plain, *targs))
    n = tp.n_rays
    tk, tc = timed["tracker draw"][:2]
    # a ray: its index (8 B), point, cosine and flag (17 B) read; 44 B and two
    # flags written; ~30 operations
    rec_draw = record("ray_draw", "ray_prep.cu", "nerfloam_tpu/core/tracking.py:150-163 (the "
                      "gathers, dirs, t_cap_for, d_meas, depth_ok, bias_ray; an XLA fusion, no "
                      "TPU kernel)", 0.0, k_ms, p_ms, 71 * n, 30 * n,
                      dev=partial(tr.ray_draw, *targs),
                      forms={f"ray_draw, BA without a superset, window of {W}": (
                          partial(tr.ray_draw, *eargs), KERNEL_FUNCTIONS["ray_draw"]),
                          "ray_draw, the tracker's draw, the parent's chain": (
                              timed["tracker draw"][3], KERNEL_FUNCTIONS["ray_prep"])},
                      site_ms=tk, parent_chain_ms=tc)
    sidx = draw_indices(val, K, gen)
    sargs = (sidx, pts, cos, val, bp.truncation, bp.max_depth)
    k_ms, p_ms = median_ms(partial(tr.ray_superset, *sargs)), median_ms(
        partial(tr.ray_superset_plain, *sargs))
    sk, sc = timed[f"BA superset, window of {W}"][:2]
    # a ray: index 8 B, point, cosine, flag 17 B read; its row 32 B, dirs 12 B,
    # t_cap 4 B and a flag written
    rec_sup = record("ray_superset", "ray_prep.cu", "nerfloam_tpu/core/ba.py:183-191 (the "
                     "superset's gathers and setup; an XLA fusion, no TPU kernel)", 0.0, k_ms,
                     p_ms, 74 * W * K, 30 * W * K, dev=partial(tr.ray_superset, *sargs),
                     forms={f"ray_superset, window of {W}, the parent's chain": (
                         timed[f"BA superset, window of {W}"][3], KERNEL_FUNCTIONS["ray_prep"])},
                     site_ms=sk, parent_chain_ms=sc)
    ridx = torch.randint(0, K, (W, bp.n_rays), generator=gen, device=dev)
    pargs = (ridx, slice(None), sups[W], active)
    k_ms, p_ms = median_ms(partial(tr.ray_pick, *pargs)), median_ms(
        partial(tr.ray_pick_plain, *pargs))
    pk, pc = timed[f"BA pick, window of {W}"][:2]
    # a ray: index 8 B, its 32 B row and flag read; 37 B written
    rec_pick = record("ray_pick", "ray_prep.cu", "nerfloam_tpu/core/ba.py:230-234, 322-329 (a "
                      "BA iteration's gathers from the superset; an XLA fusion, no TPU kernel)", 0.0,
                      k_ms, p_ms, 78 * W * bp.n_rays, 4 * W * bp.n_rays,
                      dev=partial(tr.ray_pick, *pargs),
                      forms={f"ray_pick, window of {W}, the parent's chain": (
                          timed[f"BA pick, window of {W}"][3], ())},
                      site_ms=pk, parent_chain_ms=pc)
    return [rec_keys, rec_draw, rec_sup, rec_pick]


CONST_VEL_PAIRS = 10 ** 5
CONST_VEL_CHAIN_PAIRS = 500  # the card's eager chain takes one pair a call


def const_vel_phase(gen):
    """[const_vel], kernel B: se3.const_vel (csrc/const_vel.cu, the
    deferred warm start in one launch) on CONST_VEL_PAIRS seeded pose pairs
    in each of exp_so3's branches (series, exact, exact below 0.01 rad),
    both ``full`` settings: 0 bits differ from the CPU's const_vel_plain
    (what the CPU's _const_vel takes, held to JAX's by
    tests/test_torch_defer.py); the gap to the card's eager chain of the
    parent (parent_const_vel: cuBLAS's products) in ulp of each pose's
    largest entry, printed; timed in turns against that chain. Returns
    its record."""
    dev = gen.device
    worst = {}
    for branch, sigma in (("series", 3e-5), ("exact", 0.8), ("exact_small", 1e-3)):
        rng = np.random.default_rng(14)
        n = CONST_VEL_PAIRS
        prev = np.concatenate([rng.uniform(-50, 50, (n, 3)), rng.normal(0, sigma, (n, 3))], 1)
        step = np.concatenate([rng.normal(0, 1.0, (n, 3)), rng.normal(0, sigma, (n, 3))], 1)
        last = torch.as_tensor((prev + step).astype(np.float32))
        prev = torch.as_tensor(prev.astype(np.float32))
        for full in (True, False):
            got = se3.const_vel(last.to(dev), prev.to(dev), full).cpu()
            ref = se3.const_vel_plain(last, prev, full)
            differ = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
            m = CONST_VEL_CHAIN_PAIRS
            chain = torch.stack([parent_const_vel(a, b, full) for a, b in
                                 zip(last[:m].to(dev), prev[:m].to(dev))]).cpu().double()
            r = got[:m].double()
            ulp = np.spacing(r.abs().amax(1, keepdim=True).float().numpy()).astype(np.float64)
            gap = float(((chain - r).abs().numpy() / ulp).max())
            same = float((chain == r).all(1).double().mean())
            worst[(branch, full)] = gap
            log(f"[const_vel] {branch} (sigma {sigma} rad), full={full}: {differ} of {6 * n} "
                f"values differ in their bits from the CPU's const_vel_plain; against the card's "
                f"eager chain (first {m} pairs): within {gap:.4g} ulp of each pose's largest "
                f"entry, {same:.4f} of poses equal")
            check(differ == 0, f"[const_vel] {differ} values differ from the CPU's "
                  f"({branch}, full={full})")
    last = torch.tensor([3.1, -0.4, 0.2, 0.01, -0.02, 0.3], device=dev)
    prev = torch.tensor([2.2, -0.3, 0.21, 0.012, -0.018, 0.28], device=dev)
    kern, chain = partial(se3.const_vel, last, prev, True), partial(parent_const_vel, last, prev,
                                                                    True)
    k_ms, c_ms = paired_median_ms(kern, chain)
    p_ms = median_ms(partial(se3.const_vel_plain, last, prev, True))
    log(f"[const_vel] one warm start, in turns: const_vel {k_ms:.4f} ms, the parent's chain "
        f"{c_ms:.4f} ms; host us (card idle before each): const_vel {host_us_idle(kern):.2f}, "
        f"the parent's chain {host_us_idle(chain):.2f}")
    return record("const_vel", "const_vel.cu", "nerfloam_tpu/core/pipeline.py:60-72 "
                  "(_const_vel_jit: pose matrices, inverse, products, log_so3; XLA fusions, no "
                  "TPU kernel)", 0.0, k_ms, p_ms, 72, 900, dev=kern,
                  forms={"const_vel, the parent's chain": (
                      chain, KERNEL_FUNCTIONS["exp_so3"] + KERNEL_FUNCTIONS["trig"]
                      + KERNEL_FUNCTIONS["norm3"])},
                  parent_chain_ms=c_ms,
                  chain_ulp={f"{b}, full={f}": g for (b, f), g in worst.items()})


def write_kitti_dir(ds, path):
    """The dataset's scans as a KITTI odometry directory: velodyne/%06d.bin
    (x y z and a zero reflectance, f32) and poses_lidar.txt (each ground-truth
    pose relative to the first, 3 x 4 rows: a KITTI loader without use_gt
    starts at the identity). Returns those relative poses (n, 4, 4).
    scripts/port_ate_reference.py --kitti-dir writes the same files."""
    os.makedirs(os.path.join(path, "velodyne"), exist_ok=True)
    gt = np.asarray(ds.gt_trajectory(), np.float64)
    rel = np.linalg.inv(gt[0]) @ gt
    for i in range(len(ds)):
        _, pts, _, _ = ds[i]
        xyzr = np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1)
        xyzr.astype(np.float32).tofile(os.path.join(path, "velodyne", f"{i:06d}.bin"))
    np.savetxt(os.path.join(path, "poses_lidar.txt"), rel[:, :3, :].reshape(len(rel), 12))
    return rel


def kitti_dir_digest(path):
    """sha256 (first 16 hex digits) of a KITTI directory's scans and poses,
    in file order: the same files on every machine that writes them."""
    h = hashlib.sha256()
    names = sorted(os.listdir(os.path.join(path, "velodyne")))
    for name in [os.path.join("velodyne", n) for n in names] + ["poses_lidar.txt"]:
        with open(os.path.join(path, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def make_frames(slam, ds, n=None):
    """The dataset's frames (its first ``n``); a dataset with ground-truth
    poses (``data_specs.use_gt``) gives mapping-only frames."""
    frames = []
    for i in range(len(ds) if n is None else n):
        idx, pts, cos, pose = ds[i]
        frames.append(Frame.from_raw(idx, pts, cos, pose, slam.points_pad,
                                     has_gt_pose=pose is not None))
    frames[0].pose6 = pose6_from_matrix_np(ds.get_init_pose(0))
    for f in frames:
        f.device_arrays(slam.device)
    return frames


def mesh_report(tag, slam):
    """The logger's files read back and checked, and the mesh's sizes and
    times (CUDA-event sections of the two meshes finalize wrote: the device
    extract with its copy to the host, the host weld) plus one cleaned
    extraction."""
    misc, mesh = (os.path.join(slam.logger.dir, d) for d in ("misc", "mesh"))
    poses = np.load(os.path.join(misc, "frame_poses.npy"))
    check(poses.shape == (len(slam.state.final_poses), 4, 4), "frame_poses.npy has a wrong shape")
    check(np.loadtxt(os.path.join(misc, "frame_poses.txt")).shape == (len(poses), 12),
          "frame_poses.txt is not KITTI format")
    check(np.load(os.path.join(misc, "tracking_trajectory.npy")).shape == poses.shape,
          "tracking_trajectory.npy has a wrong shape")
    for fname in ("final_mesh_noreplay.ply", "final_mesh.ply"):
        v, f = read_ply(os.path.join(mesh, fname))
        check(f is not None and len(f) > 0, f"{fname} has no face")
        check(np.isfinite(v).all(), f"{fname} has a non-finite vertex")
        check(f.min() >= 0 and f.max() < len(v), f"{fname} has a face index out of range")
        check(bool(((f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])).all()),
              f"{fname} has a degenerate face")
    n_surf = int(vm.surface_voxel_ids(slam.state.map_state).numel())
    tris = mesher.extract_triangles(slam.state.map_state, slam.map_cfg, slam.state.decoder_params,
                                    slam.mesh_res, slam.compute_dtype)
    vc, fc = slam.extract_mesh(clean=True)
    check(0 < len(fc) <= len(f), "clean_mesh kept no face or grew the mesh")
    sec = slam.prof.summary()
    log(f"{tag} mesh: {n_surf} surface voxels, {len(tris)} triangles, {len(v)} vertices, "
        f"{len(f)} faces ({len(fc)} after clean_mesh); ms per mesh: device extract "
        f"{sec['mesh_extract']['mean_ms']:.3f}, host weld {sec['mesh_weld']['mean_ms']:.3f}, "
        f"clean {sec['mesh_clean']['mean_ms']:.3f} "
        f"({sec['mesh_extract']['count']} extractions)")
    if tag == "[main kitti_quality]":
        mesh_split(tag, slam)
    return len(tris), len(f), len(fc)


def mesh_split(tag, slam, calls=5):
    """Where one mesh extract's time goes (``extract_triangles``, as the
    pipeline's ``extract_mesh`` calls it, on the path's final map): the
    wall ms of a first call and the median of ``calls`` more without the
    profiler, then torch.profiler over ``calls`` calls: every device
    operation by name (launches and device us a call) and the host
    operations with the most self CPU time. The launch counters are put
    back after it: the path counts only its own meshes."""
    from torch.profiler import ProfilerActivity, profile

    saved = counters()
    fn = partial(mesher.extract_triangles, slam.state.map_state, slam.map_cfg,
                 slam.state.decoder_params, slam.mesh_res, slam.compute_dtype,
                 scratch=slam.mesh_scratch)
    walls = []
    for _ in range(calls + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    for k, (mod, attr) in _COUNTERS.items():
        setattr(mod, attr, saved[k])
    events = prof.key_averages()
    on_dev = [e for e in events if _on_device(e)]
    dev = lambda e: getattr(e, "self_device_time_total", 0.0) / calls  # noqa: E731
    log(f"{tag} mesh split, one extract_triangles call (res {slam.mesh_res}): wall "
        f"{walls[0]:.3f} ms the first call, {float(np.median(walls[1:])):.3f} ms the median of "
        f"{calls} more (no profiler); device {sum(map(dev, on_dev)) / 1e3:.3f} ms in "
        f"{sum(e.count for e in on_dev) / calls:g} launches a call (profile):")
    for e in sorted(on_dev, key=dev, reverse=True):
        log(f"{tag} mesh split device {dev(e):10.2f} us {e.count / calls:6g} x  {e.key[:100]}")
    host = sorted((e for e in events if not _on_device(e)), key=lambda e: -e.self_cpu_time_total)
    for e in host[:15]:
        log(f"{tag} mesh split host {e.self_cpu_time_total / calls / 1e3:8.3f} ms self CPU "
            f"{e.count / calls:6g} x  {e.key[:100]}")


def gate_mesh(tag, slam, ds, poses, gt):
    """The mesh half of the replica gate (scripts/eval_replica.py:130-141):
    the cleaned mesh, 200,000 samples moved by the trajectory's Umeyama
    transform, against the observed ground-truth cloud at 0.2 m."""
    verts, faces = slam.extract_mesh(clean=True)
    check(len(faces) > 0, f"{tag} the cleaned mesh is empty")
    m = score_mesh(verts, faces, poses, gt, ds, n_samples=200000, f_threshold=0.2)
    log(f"{tag} mesh: {len(verts)} vertices, {len(faces)} faces after clean_mesh; f_score "
        f"{m['f_score']:.4f} (gate > {GATE60_F_SCORE_MIN}), chamfer_l1 {m['chamfer_l1_m']:.4f} m "
        f"(gate < {GATE60_CHAMFER_L1_MAX}), accuracy {m['accuracy_m']:.4f} m, completeness "
        f"{m['completeness_m']:.4f} m, precision {m['precision']:.4f}, recall {m['recall']:.4f}")
    check(m["f_score"] > GATE60_F_SCORE_MIN, f"f_score {m['f_score']} not above the gate ({tag})")
    check(m["chamfer_l1_m"] < GATE60_CHAMFER_L1_MAX,
          f"chamfer_l1 {m['chamfer_l1_m']} not under the gate ({tag})")


def main_path(name, slam, ds, label=None):
    """One run of a config through NerfLoamSLAM_torch: every frame of its
    dataset (30, or the replica gate's 60), then finalize (with a logger:
    both meshes and the pose files) and, on the replica gate, the cleaned
    mesh and its score. The mesh work lies outside the scans/s window."""
    label = label or name
    path = "replica_gate60_exact" if label.startswith("replica_gate60_exact") else name
    frames = make_frames(slam, ds)
    # remove_back's share, from the frames as the pipeline receives them (no
    # motion yet: the rule takes +x, as in JAX); the first frame is not mapped so
    back = back_share(frames[1:], slam.key_distance) if slam.remove_back else None

    zero_counters()
    t_start = time.perf_counter()
    slam.process_first_frame(frames[0])
    n_active0 = int(slam.state.map_state.n_active)  # outside the window
    for f in frames[1:WARMUP_FRAMES]:
        slam.process_frame(f)
    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), time.process_time()
    for f in frames[WARMUP_FRAMES:]:
        slam.process_frame(f)
    slam._drain()  # defer_sync: the last frame's finalize inside the window
    torch.cuda.synchronize()
    dt, cpu = time.perf_counter() - t0, time.process_time() - c0
    poses = np.asarray(slam.finalize())
    torch.cuda.synchronize()
    total = time.perf_counter() - t_start
    gt = ds.gt_trajectory()[: len(poses)]
    tag = f"[main {label}]"
    if name == "replica_gate60":
        gate_mesh(tag, slam, ds, poses, gt)
    mesh = mesh_report(tag, slam) if slam.logger is not None else None
    launches = counters()
    n_timed = len(frames) - WARMUP_FRAMES
    scans = n_timed / dt
    ate = ate_rmse(poses, gt, align=False)
    log(f"{tag} {len(frames)} frames in {total:.2f} s (finalize included); "
        f"scans/s over frames {WARMUP_FRAMES}-{len(frames) - 1}: {scans:.4f}; host CPU "
        f"{cpu / n_timed:.4f} s a frame (the process, all its threads)")
    log(f"{tag} launches: {launches}; per frame ({len(frames)} frames + finalize): "
        + ", ".join(f"{k} {v / len(frames):.2f}" for k, v in launches.items()))
    log(f"{tag} overflow events {slam.overflow_events}, dropped {slam.dropped_delta_events}, "
        f"host syncs {slam.host_syncs} ({slam.host_syncs / len(frames):.2f} per frame)")
    log(f"{tag} sections (ms): " + json.dumps(
        {k: round(v["mean_ms"], 3) for k, v in slam.prof.summary().items()}))
    ms = slam.state.map_state
    log(f"{tag} final sdf_bias {slam.sdf_bias.tolist()}, num_lat {int(ms.num_lat)}, "
        f"n_active {int(ms.n_active)} (after the first frame {n_active0}; active_cap "
        f"{slam.map_cfg.active_cap}), keyframes {len(slam.state.keyframes)}")
    check(len(poses) == len(frames), f"{len(poses)} poses for {len(frames)} frames")
    check(np.isfinite(poses).all(), "non-finite pose")
    check(bool(torch.isfinite(ms.embeddings.float()).all()), "non-finite embeddings")
    check(all(bool(torch.isfinite(w).all()) for w in slam.state.decoder_params["w"]),
          "non-finite decoder")
    check(np.isfinite(slam.sdf_bias).all(), "non-finite sdf_bias")
    for k in PATH_KERNELS[path]:
        check(launches[k] > 0, f"kernel {k} never launched on the {label} path")
    check(launches["lm_tail"] == launches["gn_system"] and launches["lm_step"] == 0,
          f"{launches['lm_tail']} GN tails and {launches['lm_step']} lone LM steps for "
          f"{launches['gn_system']} GN iterations ({label})")
    check(slam.dropped_delta_events == 0, "dropped deltas")
    if slam.bp_current.exact_embedding_grads:
        exact_checks(tag, slam, launches, len(frames))
    if name == "kitti_knobs":
        knobs_checks(tag, slam, len(frames), back)
    if name == "kitti_mapping_gt":
        mapping_gt_checks(tag, slam, launches, mesh, gt)
    if name in DEFER_PATHS:
        defer_checks(name, tag, slam, launches, len(frames))
    if name == "kitti_quality_s2s":
        # K11a once per tracked frame (and per replayed one), K11b once per GN iteration
        replays = sum(slam.overflow_events.values())
        n_a, n_b = launches["build_prev_scan"], launches["s2s_system"]
        check(len(frames) - 1 <= n_a <= len(frames) - 1 + replays,
              f"K11a launched {n_a} times for {len(frames) - 1} tracked frames")
        check(n_b == launches["gn_system"],
              f"K11b launched {n_b} times for {launches['gn_system']} GN iterations")
    if name == "replica_gate60":
        aligned = ate_rmse(poses, gt, align=True)
        growth = sum(slam.overflow_events.values())
        log(f"{tag} ATE raw {ate:.4f} m (gate {GATE60_ATE_RAW_MAX}), aligned {aligned:.4f} m "
            f"(gate {GATE60_ATE_ALIGNED_MAX}); growth events {growth}; lateral drift "
            f"{drift_lat_cm_f(poses, gt):.4f} cm/frame (printed, not gated)")
        err = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1)
        log(f"{tag} raw translation error per frame (m): "
            + " ".join(f"{e:.4f}" for e in err))
        check(aligned < GATE60_ATE_ALIGNED_MAX,
              f"ATE aligned {aligned} not under {GATE60_ATE_ALIGNED_MAX} ({label})")
        if path == "replica_gate60":
            check(ate < GATE60_ATE_RAW_MAX, f"ATE raw {ate} not under {GATE60_ATE_RAW_MAX} "
                  f"({label})")
            check(growth > 0, f"no growth event on the {label} path")
        else:  # one draw of the random stream; its raw ATE is held on the spread (gate_spread)
            log(f"{tag} JAX on the same config (CPU): ATE raw {GATE60_EXACT_JAX['raw']:.4f} m, "
                f"aligned {GATE60_EXACT_JAX['aligned']:.4f} m; this one draw's raw ATE "
                f"{ate:.4f} m is {'under' if ate < GATE60_ATE_RAW_MAX else 'NOT under'} the "
                f"gate's {GATE60_ATE_RAW_MAX} m; held on the median over generator seeds "
                f"{GATE60_SPREAD_SEEDS[0]}-{GATE60_SPREAD_SEEDS[-1]} ([gate spread])")
    else:
        log(f"{tag} ATE {ate:.4f} m (bound {ate_bound(name):.4f} m from JAX "
            f"{ATE_JAX[name]:.4f} m); final position {poses[-1][:3, 3].tolist()}, "
            f"GT {gt[-1][:3, 3].tolist()}")
        check(ate <= ate_bound(name), f"ATE {ate} above bound {ate_bound(name)} ({label})")
    ates = {"raw": ate}
    if name == "replica_gate60":
        ates["aligned"] = aligned
    run = {"poses": poses, "keyframes": len(slam.state.keyframes),
           "sdf_bias": slam.sdf_bias.tolist()}
    return launches, scans, slam.prof.summary(), ates, run


def defer_checks(name, tag, slam, launches, n_frames):
    """A deferred path: nothing in flight after finalize, a telemetry row
    for every tracked frame; on the quality config no overflow found with a
    frame in flight, on the growing budget config at least one active-set
    growth found so, and K7 undone at least twice for each (the newer
    frame's insert and the older one's)."""
    replays, undo = slam._defer_replays, launches["undo_insert"]
    rows = len(slam.state.frame_telemetry)
    log(f"{tag} defer_sync: {replays} deferred replays, overflow events "
        f"{slam.overflow_events}, K7 undone {undo} times, {rows} telemetry rows for "
        f"{n_frames - 1} tracked frames, in flight after finalize: {slam._inflight is not None}")
    check(slam.defer_sync, f"{tag} does not run defer_sync")
    check(slam._inflight is None, f"{tag}: a frame is in flight after finalize")
    check(rows == n_frames - 1, f"{tag}: {rows} telemetry rows for {n_frames - 1} tracked frames")
    if name == "kitti_budget_defer_grow":
        check(slam.overflow_events["active"] >= 1, f"{tag}: the active set never grew")
        check(replays >= 1, f"{tag}: no overflow was found with a frame in flight")
        check(undo >= 2 * replays, f"{tag}: K7 undone {undo} times for {replays} deferred replays")
    else:
        check(replays == 0, f"{tag}: {replays} deferred replays")


def back_share(frames, key_distance):
    """The share of the frames' valid points that remove_back drops."""
    kept = sum(int(f.without_back_points(key_distance).valid.sum()) for f in frames)
    total = sum(int(f.valid.sum()) for f in frames)
    return (total - kept) / max(total, 1)


def knobs_checks(tag, slam, n_frames, back):
    """kitti_knobs: the replay steps the schedule took (those of JAX's run
    of the same config and frames), the BA-delta telemetry (a row for every
    tracked frame, its along column ~0 under ba_pose_project=along) and
    remove_back's share of the points (data alone: JAX's to the digit)."""
    steps = slam.prof.summary().get("replay", {}).get("count", 0)
    rows = slam.state.ba_delta_telemetry
    along = max(abs(r[1]) for r in rows) if rows else float("nan")
    lat = max(abs(r[2]) for r in rows) if rows else float("nan")
    log(f"{tag} replay steps {steps} (JAX {KNOBS_JAX['replay_steps']}); BA-delta telemetry "
        f"{len(rows)} rows, largest |along| {along:.3e} m (JAX {KNOBS_JAX['max_abs_along_m']:.3e}; "
        f"bound {ALONG_MAX_M:g}), largest |lateral| {lat:.3e} m; remove_back dropped "
        f"{back:.6f} of the valid points (JAX {KNOBS_JAX['remove_back_dropped']:.6f})")
    check(steps == KNOBS_JAX["replay_steps"],
          f"{steps} replay steps where JAX took {KNOBS_JAX['replay_steps']}")
    check(len(rows) == n_frames - 1, f"{len(rows)} BA-delta rows for {n_frames - 1} tracked frames")
    check(along < ALONG_MAX_M, f"the along column reads {along} m under ba_pose_project=along")
    check(abs(back - KNOBS_JAX["remove_back_dropped"]) < 1e-6,
          f"remove_back dropped {back} of the points, JAX {KNOBS_JAX['remove_back_dropped']}")


def mapping_gt_checks(tag, slam, launches, mesh, gt):
    """kitti_mapping_gt: no tracker (no K3 launch, no tracker telemetry),
    the tracking trajectory the GT poses; the map's rows and the mesh's
    triangles printed beside JAX's CPU run of the same config."""
    traj = np.asarray(slam.get_raw_trajectory())
    err = float(np.abs(traj[:, :3, 3] - gt[:len(traj), :3, 3]).max())
    tris, faces, faces_clean = mesh
    log(f"{tag} mapping only: num_lat {int(slam.state.map_state.num_lat)} (JAX "
        f"{MAPPING_GT_JAX['num_lat']}); mesh {faces} triangles welded, {faces_clean} after "
        f"clean_mesh (JAX {MAPPING_GT_JAX['mesh_triangles']}, "
        f"{MAPPING_GT_JAX['mesh_triangles_clean']}); {tris} before the weld; tracking "
        f"trajectory against GT {err:.2e} m; K3 launches {launches['gn_system']}")
    check(launches["gn_system"] == 0, "the tracker's K3 launched on the mapping-only path")
    check(not slam.state.frame_telemetry and not slam.state.ba_delta_telemetry,
          "tracker telemetry on the mapping-only path")
    check(err < 1e-5, f"the tracking trajectory is {err} m off the GT poses")


def gaussian_run(here, ds):
    """The gaussian positional embedder on the card: 10 frames of the
    budget config with ``decoder_specs.embedder=gaussian`` (its B trained
    by BA with the decoder), every pose, table and decoder tensor finite."""
    cfg = load_cfg(here, "kitti_budget", decoder_specs={"embedder": "gaussian"})
    slam = NerfLoamSLAM_torch(cfg, ds, device="cuda")
    frames = make_frames(slam, ds, GAUSSIAN_FRAMES)
    slam.process_first_frame(frames[0])
    for f in frames[1:]:
        slam.process_frame(f)
    poses = np.asarray(slam.finalize())
    torch.cuda.synchronize()
    dec = slam.state.decoder_params
    ate = ate_rmse(poses, ds.gt_trajectory()[:len(poses)], align=False)
    log(f"[gaussian kitti_budget] {len(poses)} frames, embedder gaussian (B {tuple(dec['gaussian_B'].shape)}"
        f", first layer {tuple(dec['w'][0].shape)}): ATE {ate:.4f} m (printed, not bounded), "
        f"dropped {slam.dropped_delta_events}")
    check(np.isfinite(poses).all() and len(poses) == GAUSSIAN_FRAMES, "gaussian: a pose is lost")
    check(bool(torch.isfinite(slam.state.map_state.embeddings.float()).all())
          and all(bool(torch.isfinite(t).all()) for t in dec["w"] + dec["b"] + [dec["gaussian_B"]]),
          "gaussian: a non-finite table or decoder tensor")
    check(slam.dropped_delta_events == 0, "gaussian: dropped deltas")
    return ate


class TimedKitti(KittiLoader):
    """The port's KITTI loader (its C++ filter and segmenter), the wall ms
    of each ``__getitem__`` kept (the prefetching thread's, in a run)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.ms = []

    def __getitem__(self, index):
        t0 = time.perf_counter()
        out = super().__getitem__(index)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


class NumpyKitti(TimedKitti):
    """The same loader on the numpy twins, ``filter_scan`` and
    ``ground.segment_ground`` (the JAX package's fallback): chip_smoke's
    comparison, not a knob of the package."""

    def __getitem__(self, index):
        t0 = time.perf_counter()
        points = self.filter_scan(self.read_scan(index).astype(np.float32))
        _, cos = ground.segment_ground(points)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return index, points, cos, None


def twin_agreement(tag, points, mask, cos):
    """The C++ segmenter's mask and cosines against the numpy twin's on the
    same points: the share of equal mask entries (at least TWIN_MASK_AGREE,
    JAX's tests/test_native.py:41), and, where both say ground, the points
    whose cosines differ by more than TWIN_COS_TOL (JAX's atol there). The
    two pick a cell's seeds otherwise (an order statistic against an
    interpolated quantile), so a few cells fit another plane: those points
    may be at most TWIN_COS_SHARE of the ground points both find."""
    mt, ct = ground.segment_ground(points)
    agree = float((mask == mt).mean()) if len(points) else 1.0
    both = mask & mt
    gap = np.abs(cos[both] - ct[both])
    n_over = int((gap > TWIN_COS_TOL).sum())
    check(agree >= TWIN_MASK_AGREE, f"{tag}: masks equal on {agree} of the points")
    check(n_over <= TWIN_COS_SHARE * both.sum(),
          f"{tag}: cosine gaps over {TWIN_COS_TOL} on {n_over} of {int(both.sum())} points")
    return agree, (n_over, int(both.sum()), float(gap.max()) if len(gap) else 0.0)


def jax_scene_checks():
    """tests/test_native.py:32-44 of the JAX package, on its own scene
    (6,000 ground points at -1.7 m, a wall of 800 at x = 9 m), for the
    port's library as it is built on this host: the ground found and the
    wall rejected, masks 90% equal to the numpy twin's, and every cosine
    within 0.05 of the twin's where both say ground."""
    rng = np.random.default_rng(0)
    n = 6000
    ang, r = rng.uniform(0, 2 * np.pi, n), rng.uniform(2, 25, n)
    floor_ = np.stack([r * np.cos(ang), r * np.sin(ang), np.full(n, -1.7) + rng.normal(0, 0.02, n)],
                      -1)
    wall = np.stack([np.full(800, 9.0), rng.uniform(-6, 6, 800), rng.uniform(-1.5, 3.0, 800)], -1)
    pts = np.concatenate([floor_, wall]).astype(np.float32)
    m, c = segment_ground_native(pts)
    mt, ct = ground.segment_ground(pts)
    both = m & mt
    gap = float(np.abs(c[both] - ct[both]).max())
    log(f"[loader] JAX's native test scene: ground found on {m[:n].mean():.4f} of the floor, "
        f"{m[n:].mean():.4f} of the wall; masks equal to the twin's on {(m == mt).mean():.4f}; "
        f"largest cosine gap {gap:.3e} where both say ground")
    check(m[:n].mean() > 0.8 and m[n:].mean() < 0.3 and (m == mt).mean() > TWIN_MASK_AGREE
          and gap <= TWIN_COS_TOL, "[loader] the C++ segmenter fails JAX's native test")


def loader_run(cfg, kds, label, gt, device="cuda"):
    """``NerfLoamSLAM_torch.run()`` on a KITTI loader (the prefetching
    loader feeds it): wall s, scans/s over frames WARMUP_FRAMES to the end
    (from the entry of that frame's process_frame to the entry of finalize,
    synchronized), host CPU s a frame, the launches, the ATE."""
    slam = NerfLoamSLAM_torch(cfg, kds, device=device)
    stamps, process_frame, fin = [], slam.process_frame, slam.finalize

    def timed_frame(frame):
        stamps.append((time.perf_counter(), time.process_time()))
        return process_frame(frame)

    def timed_finalize():
        torch.cuda.synchronize()
        stamps.append((time.perf_counter(), time.process_time()))
        return fin()

    slam.process_frame, slam.finalize = timed_frame, timed_finalize
    zero_counters()
    t0 = time.perf_counter()
    poses = np.asarray(slam.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    n_timed = len(poses) - WARMUP_FRAMES
    (w0, c0), (w1, c1) = stamps[WARMUP_FRAMES - 1], stamps[-1]  # stamps[0] is frame 1
    ate = ate_rmse(poses, gt[: len(poses)], align=False)
    log(f"[loader] {label}: {len(poses)} frames in {wall:.2f} s (run(), finalize included); "
        f"scans/s over frames {WARMUP_FRAMES}-{len(poses) - 1}: {n_timed / (w1 - w0):.4f}; host "
        f"CPU {(c1 - c0) / n_timed:.4f} s a frame; __getitem__ in the prefetching thread: median "
        f"{np.median(kds.ms):.3f} ms over {len(kds.ms)} scans; ATE {ate:.4f} m")
    check(len(poses) == len(gt) and np.isfinite(poses).all(), f"[loader] {label}: a pose is lost")
    check(bool(torch.isfinite(slam.state.map_state.embeddings.float()).all())
          and all(bool(torch.isfinite(w).all()) for w in slam.state.decoder_params["w"]),
          f"[loader] {label}: a non-finite table or decoder tensor")
    check(slam.dropped_delta_events == 0, f"[loader] {label}: dropped deltas")
    return {"launches": launches, "scans": n_timed / (w1 - w0), "cpu": (c1 - c0) / n_timed,
            "wall": wall, "ate": ate}


def loader_phase(cfg, ds, workdir, device="cuda"):
    """[loader]: the quality config's 30 scans written as a KITTI directory
    and read back by the port's KITTI loader (its C++ filter and segmenter,
    nerfloam_tpu_torch/native) and by a local subclass on the numpy twins.
    Checks the JAX package's native test on its own scene; the C++ results
    equal between two calls, on every scan and on a ~120k-point HDL-64 scan,
    and against the twins (``twin_agreement``); times __getitem__ and the
    segmenter alone; runs the pipeline once on each loader (one pair, the
    C++ run first; ``loader_pairs`` runs pairs in turns), every
    kernel of the quality path launched, the native run's ATE held to the
    JAX package's on the same files. Returns the native run's launches."""
    kdir = os.path.join(workdir, "kitti_seq")
    gt = write_kitti_dir(ds, kdir)
    plain = KittiLoader(kdir, max_depth=40.0, min_depth=2.0)
    twin = NumpyKitti(kdir, max_depth=40.0, min_depth=2.0)
    jax_scene_checks()
    agree, gaps, scans_differ, n_pts, ms_native = [], [], 0, [], []
    for i in range(len(plain)):
        t0 = time.perf_counter()
        _, p, c, _ = plain[i]
        ms_native.append((time.perf_counter() - t0) * 1e3)
        _, p2, c2, _ = plain[i]
        check(np.array_equal(p, p2) and np.array_equal(c, c2),
              f"[loader] scan {i}: two calls of the C++ path differ")
        scans_differ += not np.array_equal(twin[i][1], p)
        m, mc = segment_ground_native(p)
        check(np.array_equal(mc, c), f"[loader] scan {i}: the loader's cosines are not the "
              "segmenter's")
        a, g = twin_agreement(f"[loader] scan {i}", p, m, c)
        agree.append(a)
        gaps.append(g)
        n_pts.append(len(p))
    log(f"[loader] {len(plain)} KITTI scans (files' sha256 {kitti_dir_digest(kdir)}) of "
        f"{min(n_pts)}-{max(n_pts)} points (2-40 m, z > -3): "
        f"__getitem__ median {np.median(ms_native):.3f} ms with the C++ path, "
        f"{np.median(twin.ms):.3f} ms on the numpy twins (alone, in turns); the numpy filter's "
        f"rows differ from the C++ filter's in {scans_differ} scans; against the numpy "
        f"segmenter: masks equal on {min(agree):.5f}-{max(agree):.5f} of the points; where both "
        f"say ground, cosine gaps over {TWIN_COS_TOL} on {sum(n for n, _, _ in gaps)} of "
        f"{sum(b for _, b, _ in gaps)} points (at most {max(n for n, _, _ in gaps)} a scan), "
        f"largest {max(x for _, _, x in gaps):.4f}")
    big = SyntheticDataset(n_frames=30, max_depth=80.0, min_depth=1.0, seed=0, n_beams=64,
                           n_azimuth=2048, world="kitti_replica")[0][1]
    m1, c1 = segment_ground_native(big)
    m2, c2 = segment_ground_native(big)
    check(np.array_equal(m1, m2) and np.array_equal(c1, c2),
          "[loader] the HDL-64 scan: two calls of the C++ segmenter differ")
    a, (n_over, n_both, gap) = twin_agreement("[loader] the HDL-64 scan", big, m1, c1)
    t_nat, t_np = [], []
    for _ in range(5):
        for fn, ts in ((segment_ground_native, t_nat), (ground.segment_ground, t_np)):
            t0 = time.perf_counter()
            fn(big)
            ts.append((time.perf_counter() - t0) * 1e3)
    log(f"[loader] segmenter alone on one HDL-64 scan (64 x 2048, kitti_replica world, {len(big)} "
        f"points): C++ {np.median(t_nat):.3f} ms, numpy twin {np.median(t_np):.3f} ms (median of 5, "
        f"in turns); masks equal on {a:.5f}; cosine gaps over {TWIN_COS_TOL} on {n_over} of "
        f"{n_both} points where both say ground, largest {gap:.4f}")
    native = loader_run(cfg, TimedKitti(kdir, max_depth=40.0, min_depth=2.0), "C++ loader", gt,
                        device)
    twin = loader_run(cfg, NumpyKitti(kdir, max_depth=40.0, min_depth=2.0),
                      "numpy-twin loader", gt, device)
    for k in PATH_KERNELS["loader"]:
        check(native["launches"][k] > 0, f"kernel {k} never launched on the loader path")
    bound_ = max(1.5 * LOADER_ATE_JAX, LOADER_ATE_JAX + 0.05)
    log(f"[loader] scans/s C++ {native['scans']:.4f}, numpy twin {twin['scans']:.4f} (one pair, "
        f"the C++ run first; loader_pairs runs pairs in turns); ATE C++ {native['ate']:.4f} m "
        f"(bound {bound_:.4f} from JAX {LOADER_ATE_JAX:.4f} m on the same files), numpy twin "
        f"{twin['ate']:.4f} m (printed)")
    check(native["ate"] <= bound_, f"[loader] ATE {native['ate']} above bound {bound_}")
    return native["launches"]


LOADER_PAIR_ORDER = ("C++", "numpy", "numpy", "C++") * 5


def loader_pairs(cfg, ds, workdir, device="cuda"):
    """[loader] pairs: NerfLoamSLAM_torch.run() on the quality scans as
    KITTI files through the C++ loader and the numpy-twin loader, ten pairs
    in turns (LOADER_PAIR_ORDER: each loader first in half of them): each
    run's scans/s, host CPU s a frame and wall s; then each pair's scans/s
    ratio, the pairs the C++ loader wins, each loader's median scans/s and
    the distance between the quartiles of each loader's own runs. Printed,
    not gated."""
    kdir = os.path.join(workdir, "kitti_pairs")
    gt = write_kitti_dir(ds, kdir)
    make = {"C++": TimedKitti, "numpy": NumpyKitti}
    runs = [(name, loader_run(cfg, make[name](kdir, max_depth=40.0, min_depth=2.0),
                              f"pairs run {i} {name} loader", gt, device))
            for i, name in enumerate(LOADER_PAIR_ORDER)]
    pairs = [dict(runs[i:i + 2]) for i in range(0, len(runs), 2)]
    ratio = [p["C++"]["scans"] / p["numpy"]["scans"] for p in pairs]
    d_cpu = [p["C++"]["cpu"] - p["numpy"]["cpu"] for p in pairs]
    d_wall = [p["C++"]["wall"] - p["numpy"]["wall"] for p in pairs]
    scans = {k: [r["scans"] for n, r in runs if n == k] for k in make}
    spread = {k: float(np.subtract(*np.percentile(v, [75, 25]))) for k, v in scans.items()}
    log(f"[loader] pairs in turns ({len(pairs)}, {', '.join(LOADER_PAIR_ORDER[:4])} repeated): "
        f"scans/s C++ / numpy twin {', '.join(f'{r:.4f}' for r in ratio)} (median "
        f"{np.median(ratio):.4f}; the C++ loader faster in {sum(r > 1 for r in ratio)} of "
        f"{len(pairs)}); host CPU s a frame, C++ minus twin, "
        f"{', '.join(f'{d:+.4f}' for d in d_cpu)} (median {np.median(d_cpu):+.4f}); wall s of "
        f"run(), C++ minus twin, {', '.join(f'{d:+.2f}' for d in d_wall)} (median "
        f"{np.median(d_wall):+.2f})")
    log(f"[loader] pairs: median scans/s C++ {np.median(scans['C++']):.4f}, numpy twin "
        f"{np.median(scans['numpy']):.4f}; quartile distance of each loader's own runs C++ "
        f"{spread['C++']:.4f}, numpy twin {spread['numpy']:.4f}")
    return runs


def subscene_phase(cfg, ds, device="cuda"):
    """[subscene]: SubsceneRunner over the quality config's 30 frames,
    SUBSCENE_FRAMES to a submap. A local subclass of the pipeline, swapped
    into parallel/subscene.py for the phase, records each submap's first
    pose6, last tracked pose, mesh size and the card's allocated bytes when
    it is made (after the previous submap's ``del``). Checks: 3 submaps, 30
    poses; each later submap's first pose6 exactly that of the previous
    submap's last_frame.pose_matrix(); face blocks offset by the vertices
    before them; the allocated bytes after each submap's del within
    SUBSCENE_MEM_SLACK of those after the first; every kernel of the quality
    path launched; the ATE within the bound of the JAX package's chained run.
    Returns the launches."""
    records = []

    class Spy(NerfLoamSLAM_torch):
        def __init__(self, *a, **kw):
            records.append({"allocated": torch.cuda.memory_allocated()})
            super().__init__(*a, **kw)

        def process_first_frame(self, frame):
            records[-1]["first_pose6"] = frame.pose6.copy()
            return super().process_first_frame(frame)

        def finalize(self):
            poses = super().finalize()
            records[-1]["last_pose"] = self.state.last_frame.pose_matrix()
            return poses

        def extract_mesh(self, *a, **kw):
            v, f = super().extract_mesh(*a, **kw)
            records[-1]["mesh"] = (len(v), len(f))
            return v, f

    zero_counters()
    t0 = time.perf_counter()
    subscene.NerfLoamSLAM_torch = Spy
    try:
        poses, (verts, faces), n_sub = SubsceneRunner(
            cfg, ds, device=device, frames_per_subscene=SUBSCENE_FRAMES).run()
    finally:
        subscene.NerfLoamSLAM_torch = NerfLoamSLAM_torch
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    allocated = [r["allocated"] for r in records[1:]] + [torch.cuda.memory_allocated()]
    launches = counters()
    poses = np.asarray(poses)
    gt = ds.gt_trajectory()[: len(poses)]
    ate = ate_rmse(poses, gt, align=False)
    bound_ = max(1.5 * SUBSCENE_ATE_JAX, SUBSCENE_ATE_JAX + 0.05)
    log(f"[subscene] {n_sub} submaps of {SUBSCENE_FRAMES} frames, {len(poses)} poses in {wall:.2f} s; "
        f"meshes {[r['mesh'] for r in records]} (vertices, faces), {len(verts)} vertices and "
        f"{len(faces)} faces in all; MB allocated after each submap's del "
        f"{[round(a / 2**20, 2) for a in allocated]}; ATE {ate:.4f} m (bound {bound_:.4f} from JAX "
        f"{SUBSCENE_ATE_JAX:.4f} m, chained the same way); launches {launches}")
    check(n_sub == 3 and len(records) == 3 and len(poses) == len(ds),
          f"[subscene] {n_sub} submaps and {len(poses)} poses")
    check(np.isfinite(poses).all() and np.isfinite(verts).all(), "[subscene] non-finite output")
    for k in (1, 2):
        check(np.array_equal(records[k]["first_pose6"],
                             pose6_from_matrix_np(records[k - 1]["last_pose"])),
              f"[subscene] submap {k} does not start at submap {k - 1}'s last tracked pose")
    v0 = f0 = 0
    for nv, nf in (r["mesh"] for r in records):
        block = faces[f0:f0 + nf]
        check(nf > 0 and block.min() >= v0 and block.max() < v0 + nv,
              "[subscene] a mesh block's faces leave its vertices")
        v0, f0 = v0 + nv, f0 + nf
    check(v0 == len(verts) and f0 == len(faces), "[subscene] the mesh is not the blocks' union")
    check(max(abs(a - allocated[0]) for a in allocated) <= SUBSCENE_MEM_SLACK,
          f"[subscene] allocated bytes after each submap {allocated}: not bounded")
    for k in PATH_KERNELS["kitti_quality"]:
        check(launches[k] > 0, f"kernel {k} never launched on the subscene path")
    check(ate <= bound_, f"[subscene] ATE {ate} above bound {bound_}")
    return launches


def sequences_phase(here, device="cuda"):
    """[sequences]: run_sequences_parallel with two budget jobs (data seeds
    SEQUENCE_SEEDS, SEQUENCE_FRAMES frames each) on the one card, then each
    job alone on a fresh NerfLoamSLAM_torch: poses and mesh np.array_equal.
    Returns the runner's launches."""
    cfgs = [load_cfg(here, "kitti_budget", seed=s, data_specs={"n_frames": SEQUENCE_FRAMES})
            for s in SEQUENCE_SEEDS]
    zero_counters()
    t0 = time.perf_counter()
    out = run_sequences_parallel([(c, get_dataset(c)) for c in cfgs],
                                 None if device == "cuda" else [torch.device(device)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    t1 = time.perf_counter()
    alone = []
    for c in cfgs:
        slam = NerfLoamSLAM_torch(c, get_dataset(c), device=device)
        alone.append((np.asarray(slam.run()), *slam.extract_mesh()))
        del slam
    torch.cuda.synchronize()
    log(f"[sequences] {len(out)} budget jobs (data seeds {SEQUENCE_SEEDS}, {SEQUENCE_FRAMES} frames) "
        f"on {[o['device'] for o in out]} in {wall:.2f} s (one worker on one card: in turn); alone "
        f"{time.perf_counter() - t1:.2f} s; meshes {[len(o['mesh'][1]) for o in out]} faces")
    for s_, o, (poses, v, f) in zip(SEQUENCE_SEEDS, out, alone):
        check(np.array_equal(np.asarray(o["poses"]), poses) and np.array_equal(o["mesh"][0], v)
              and np.array_equal(o["mesh"][1], f),
              f"[sequences] the job of data seed {s_} differs from the same job run alone")
        check(len(f) > 0 and len(poses) == SEQUENCE_FRAMES, f"[sequences] seed {s_}: no mesh")
    for k in PATH_KERNELS["kitti_budget"] + _MESH:
        check(launches[k] > 0, f"kernel {k} never launched on the sequences path")
    return launches


def dp_probe(first, slam, rank):
    """A [dp] rank's own record, read after its run (its process starts
    with every launch count at zero): its launches by kernel, each tracked
    frame's hit ratio and the tracker's raw poses; then, with ``first``
    (the one-process run's first tracked frame's inputs, or None), that
    frame's GN tracker on those inputs, its rays split over the group (the
    launches already read: a comparison, not the path)."""
    import torch.distributed as dist

    out = {"launches": counters(),
           "hits": [h for _, h, *_ in slam.state.frame_telemetry],
           "tracked6": np.stack([pose6_from_matrix_np(np.asarray(t))
                                 for t in slam.get_raw_trajectory()])}
    if first is not None:
        a, dev = first, slam.device
        ms = vm.MapState(*[t.to(dev) for t in a["map_state"]])
        dec = {k: ([t.to(dev) for t in v] if isinstance(v, list) else v.to(dev))
               for k, v in a["decoder"].items()}
        gen = torch.Generator(device=dev)
        gen.set_state(a["gen_state"])
        res = tr.track_frame_gn(ms, a["map_cfg"], a["rc"], a["tp"], dec, *(
            a[k].to(dev) for k in ("init6", "pts", "cos", "val")), gen, a["sdf_bias"].to(dev),
            None, dec_meta=a["dec_meta"], group=dist.group.WORLD)
        out["track"] = {"pose": res.pose.cpu().numpy(), "hits": int(res.hit_count)}
    return out


def dp_phase(here, device="cuda"):
    """[dp]: the quality config at its full width (2048 tracker rays, 1024 a
    rank; BA's 2048 from its 2x superset) over DP_FRAMES frames as
    DP_RANKS ranks on the one card (parallel/sharding.run_dp; the backend
    rule gives gloo for ranks that share a card) and as one process, the
    same seed. Checks: frame 1's tracked pose within DP_POSE_TOL of the
    one process's with the same hit count (below); the ATE under the quality
    bound; every rank's trajectory, tracked poses and packed table equal
    to rank 0's (run_dp checks the final poses); every kernel of the
    quality path, with K3's dp form for its one-launch form, launched on
    every rank. Frame 1's pose is held to one process's on the tracker
    alone, as JAX's tolerance is: the one-process run's first tracked
    frame's inputs (its map after frame 0, init pose, generator state) fed
    to the tracker on DP_RANKS ranks after their run (``dp_probe``). In the
    whole runs frame 0's BA is split too, and Adam's first steps turn the
    sums' other order into other updates of near-zero gradients: their
    frame-1 gap is held within DP_RUN_TOL (what dp alone moves the JAX
    package's own runs) and printed with every frame's. Prints each rank's launches
    by kernel and the wall time (no scans/s: gloo stages every all-reduce
    through the host). Returns {"dp rank r": launches}."""
    cfg = load_cfg(here, "kitti_quality", data_specs={"n_frames": DP_FRAMES})
    zero_counters()  # the one-process run is the comparison; its launches are not the path's
    t1 = time.perf_counter()
    # its first tracked frame's inputs, kept on the host as the tracker got
    # them, and what it returned
    first, real_track = {}, tr.track_frame_gn

    def keep_first(*args, **kw):
        out = real_track(*args, **kw) if first else None
        if not first:
            ms, map_cfg, rc, tp, dec, init6, pts, cos, val, gen, sdf_bias = args[:11]
            first.update(map_state=tuple(t.cpu() for t in ms), map_cfg=map_cfg, rc=rc, tp=tp,
                         decoder={k: ([t.cpu() for t in v] if isinstance(v, list) else v.cpu())
                                  for k, v in dec.items()},
                         init6=init6.cpu(), pts=pts.cpu(), cos=cos.cpu(), val=val.cpu(),
                         gen_state=gen.get_state(), sdf_bias=sdf_bias.cpu(),
                         dec_meta=kw["dec_meta"])
            check(args[11] is None and kw.get("group") is None, "[dp] an s2s or dp tracker")
            out = real_track(*args, **kw)
            first["one"] = {"pose": out.pose.cpu().numpy(), "hits": int(out.hit_count)}
        return out

    tr.track_frame_gn = keep_first
    try:
        one = NerfLoamSLAM_torch(cfg, get_dataset(cfg), device=device)
        one_poses = np.asarray(one.run())
    finally:
        tr.track_frame_gn = real_track
    one_probe = dp_probe(None, one, 0)
    wall_one = time.perf_counter() - t1
    del one
    one_first = first.pop("one")
    t0 = time.perf_counter()
    res = sharding.run_dp(cfg, get_dataset, DP_RANKS, [device] * DP_RANKS,
                          probe=partial(dp_probe, first))
    wall = time.perf_counter() - t0
    track = [r["probe"]["track"] for r in res["ranks"]]
    ranks = res["ranks"]
    gt = get_dataset(cfg).gt_trajectory()[:DP_FRAMES]
    ate, ate_one = ate_rmse(res["poses"], gt, align=False), ate_rmse(one_poses, gt, align=False)
    gaps = np.abs(res["poses"] - one_poses).max(axis=(1, 2))
    tracked_gaps = np.abs(ranks[0]["probe"]["tracked6"] - one_probe["tracked6"]).max(axis=1)
    log(f"[dp] {DP_RANKS} ranks on one card: {DP_FRAMES} frames in {wall:.2f} s wall (spawn, "
        f"rendezvous, build and the tracker check included), one process {wall_one:.2f} s; "
        f"ATE {ate:.4f} m "
        f"(one process {ate_one:.4f}, bound {ate_bound('kitti_quality'):.4f})")
    log("[dp] each frame's largest gap to one process, final poses: "
        + ", ".join(f"{g_:.3g}" for g_ in gaps) + "; tracked pose6: "
        + ", ".join(f"{g_:.3g}" for g_ in tracked_gaps))
    log(f"[dp] frame 1 hit ratio {ranks[0]['probe']['hits'][0]!r} (one process "
        f"{one_probe['hits'][0]!r}); packed table sha256 by rank "
        f"{[r['packed_sha256'][:16] for r in ranks]}")
    track_gap = max(float(np.abs(t["pose"] - one_first["pose"]).max()) for t in track)
    log(f"[dp] frame 1's tracker on the one-process run's own inputs (its map after frame 0, "
        f"init pose, generator state), its rays split over {DP_RANKS} ranks: pose within "
        f"{track_gap:.3g} of one process's (limit {DP_POSE_TOL:g}), hits "
        f"{[t['hits'] for t in track]} against {one_first['hits']}")
    for r in ranks:
        log(f"[dp] rank {r['rank']} launches: {r['probe']['launches']}")
    check(track_gap <= DP_POSE_TOL, f"[dp] frame 1's tracked pose {track_gap} from one process's")
    log(f"[dp] the whole runs' frame 1 tracked pose6 within {tracked_gaps[1]:.3g} of one "
        f"process's (limit {DP_RUN_TOL:g})")
    check(tracked_gaps[1] <= DP_RUN_TOL,
          f"[dp] the whole runs' frame 1 tracked pose {tracked_gaps[1]} from one process's")
    check(all(t["hits"] == one_first["hits"] for t in track)
          and all(np.array_equal(t["pose"], track[0]["pose"]) for t in track),
          "[dp] frame 1's hit count differs from one process's, or the ranks' poses differ")
    check(ranks[0]["probe"]["hits"][0] == one_probe["hits"][0],
          "[dp] the runs' frame 1 hit count differs from one process's")
    check(ate <= ate_bound("kitti_quality"), f"[dp] ATE {ate} above its bound")
    need = tuple(k for k in PATH_KERNELS["loader"] if k != "gn_system") + ("gn_sums",)
    for r in ranks:
        check(np.array_equal(r["poses"], ranks[0]["poses"])
              and np.array_equal(r["probe"]["tracked6"], ranks[0]["probe"]["tracked6"])
              and r["packed_sha256"] == ranks[0]["packed_sha256"],
              f"[dp] rank {r['rank']}'s trajectory or packed table differs from rank 0's")
        for k in need:
            check(r["probe"]["launches"][k] > 0,
                  f"kernel {k} never launched on the dp path's rank {r['rank']}")
        check(r["probe"]["launches"]["gn_system"] == 0,
              f"[dp] rank {r['rank']} launched K3's one-launch form")
    return {f"dp rank {r['rank']}": r["probe"]["launches"] for r in ranks}


def knobs_dropped_phase(here, device="cuda"):
    """[knobs_dropped]: KNOBS_DROPPED_FRAMES frames of the quality config
    with the knobs the JAX package measured and dropped on (KNOBS_DROPPED:
    the GN tracker's maturity weights, K3's maturity form; the keyframe
    bias probe, K8's given-points form; two bias classes). Checks: finite
    poses and a finite per-class bias target; K3's maturity form launched
    on every GN iteration and its plain form never; every other kernel of
    the quality path launched; the ATE under max(1.5 x, + 0.05 m) of the
    JAX package's on the CPU (KNOBS_DROPPED_ATE_JAX). Then one BA step over
    the last window_size keyframes (``do_mapping(selection_method=
    "previous")``), its own launches printed (not the path's). Returns the
    run's launches and [tp]'s input: the final map, decoder, a frame's
    points and its pose on the host."""
    cfg = load_cfg(here, "kitti_quality", data_specs={"n_frames": KNOBS_DROPPED_FRAMES},
                   tpu_specs=dict(KNOBS_DROPPED))
    ds = get_dataset(cfg)
    slam = NerfLoamSLAM_torch(cfg, ds, device=device)
    frames = make_frames(slam, ds)
    zero_counters()
    t0 = time.perf_counter()
    slam.process_first_frame(frames[0])
    for f in frames[1:]:
        slam.process_frame(f)
    poses = np.asarray(slam.finalize())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    gt = ds.gt_trajectory()[: len(poses)]
    ate = ate_rmse(poses, gt, align=False)
    jax_ate = KNOBS_DROPPED_ATE_JAX
    bound_ = max(1.5 * jax_ate, jax_ate + 0.05)
    n_it = slam.tp_first.num_iterations + (len(frames) - 2) * slam.tp.num_iterations
    log(f"[knobs_dropped] {len(frames)} frames of kitti_quality with {KNOBS_DROPPED} in "
        f"{wall:.2f} s wall; ATE {ate:.4f} m (JAX on the CPU {jax_ate:.4f} m, bound "
        f"{bound_:.4f}); sdf_bias [ground, non-ground] {slam.sdf_bias.tolist()}; keyframes "
        f"{len(slam.state.keyframes)}; K3 maturity form {launches['gn_system_maturity']} "
        f"launches for {n_it} GN iterations, plain form {launches['gn_system']}")
    log(f"[knobs_dropped] launches: {launches}")
    check(len(poses) == len(frames) and np.isfinite(poses).all(), "[knobs_dropped] poses")
    check(np.isfinite(slam.sdf_bias).all(), "[knobs_dropped] non-finite sdf_bias")
    check(launches["gn_system_maturity"] == n_it == launches["lm_tail"],
          f"[knobs_dropped] {launches['gn_system_maturity']} K3 maturity launches, "
          f"{launches['lm_tail']} GN tails, {n_it} GN iterations")
    check(launches["gn_system"] == 0, "[knobs_dropped] K3's plain form launched")
    for k in PATH_KERNELS["knobs_dropped"]:
        check(launches[k] > 0, f"kernel {k} never launched on the knobs_dropped path")
    check(ate <= bound_, f"[knobs_dropped] ATE {ate} above its bound {bound_}")
    kfs = slam.state.keyframes
    window = [f.index for f in slam._select_previous_window()]
    zero_counters()
    res = slam.do_mapping(None, selection_method="previous")
    torch.cuda.synchronize()
    log(f"[knobs_dropped] do_mapping(selection_method='previous') over keyframes {window} (of "
        f"{[f.index for f in kfs]}): loss {float(res.loss):.6g}, touched "
        f"{int(res.touched_count)}; its launches {counters()}")
    check(window == [f.index for f in kfs[-slam.window_size:]] and np.isfinite(float(res.loss)),
          "[knobs_dropped] the previous window")
    last = frames[-1]
    ms = slam.state.map_state
    tp_input = {"map_cfg": slam.map_cfg, "rc": slam.rc_map,
                "state": tuple(t.cpu() for t in ms),
                "decoder": {k: [t.cpu() for t in v] for k, v in slam.state.decoder_params.items()
                            if k in ("w", "b")},
                "points": torch.as_tensor(last.points), "cos": torch.as_tensor(last.points_cos),
                "valid": torch.as_tensor(last.valid), "pose6": torch.as_tensor(last.pose6),
                "crit": (slam.bp_current.truncation, slam.bp_current.max_depth,
                         slam.bp_current.fs_weight, slam.bp_current.sdf_weight),
                "lrs": list(slam.ba_lrs)}
    del slam
    return launches, tp_input


def tp_rank(rank, world_size, device, inputs):
    """One [tp] rank (module level: parallel.sharding.spawn pickles it by
    name): the dp x tp mesh, the tp decoder on TP_ROWS feature rows
    against one process's decoder_apply, then TP_STEPS steps of
    make_sharded_ba_iteration on this rank's dp block of the rays. Returns
    its launches by kernel (zeroed before the steps), the decoder error, and
    after each step the loss, the pose, the packed table's digest and the
    replicated decoder leaves' digest."""
    from nerfloam_tpu_torch.models.decoder import decoder_apply

    mesh = sharding.make_mesh(world_size)
    state = vm.MapState(*[t.to(device) for t in inputs["state"]])
    dec = {k: [t.to(device) for t in v] for k, v in inputs["decoder"].items()}
    x = inputs["x"].to(device)
    local = sharding.shard_decoder_params(dec, mesh)
    dec_err = max_abs(sharding.tp_decoder_apply(local, x, mesh), decoder_apply(dec, x))
    R = inputs["pts"].shape[0]
    n = R // mesh.dp
    rows = slice(mesh.dp_index * n, (mesh.dp_index + 1) * n)
    sync = torch.cuda.synchronize if state.packed.is_cuda else (lambda: None)
    sync()
    zero_counters()
    t0 = time.perf_counter()
    steps = tp_steps(inputs, mesh, state, local, rows, inputs["u"])
    sync()
    return {"mesh": (mesh.dp, mesh.tp, mesh.dp_index, mesh.tp_index), "dec_err": dec_err,
            "steps": steps, "launches": counters(), "seconds": time.perf_counter() - t0}


def tp_steps(inputs, mesh, state, local, rows, u):
    """[tp]'s steps of make_sharded_ba_iteration over the rays ``rows``
    with the jitter ``u``, on the device of ``state``: after each step the
    loss, the pose, the packed table's digest and the replicated decoder
    leaves' digest."""
    dev = state.packed.device
    pts, cos, val = (inputs[k][rows].to(dev) for k in ("pts", "cos", "val"))
    u, pose = u.to(dev), inputs["pose6"].to(dev)
    step, init_opt = sharding.make_sharded_ba_iteration(inputs["map_cfg"], inputs["rc"],
                                                        *inputs["crit"], mesh=mesh)
    opt = init_opt(state, local, pose)
    out = []
    for _ in range(inputs["steps"]):
        packed, local, pose, loss, opt = step(state, local, pose, pts, cos, val, inputs["lrs"], u,
                                              opt)
        state = state._replace(packed=packed)
        rep = torch.cat([local["w"][-1].reshape(-1), *local["b"][1:]])
        out.append({"loss": float(loss), "pose": pose.cpu().numpy(),
                    "packed": hashlib.sha256(packed.cpu().numpy().tobytes()).hexdigest(),
                    "replicated": hashlib.sha256(rep.cpu().numpy().tobytes()).hexdigest()})
    return out


def tp_phase(inp, device="cuda"):
    """[tp]: JAX's dp x tp layout (parallel/sharding.py: make_mesh,
    shard_decoder_params, tp_decoder_apply, make_sharded_ba_iteration) as
    TP_RANKS gloo ranks sharing the card, spawned once, at the shipped
    decoder's width (16 -> 256 -> 256 -> 1, [knobs_dropped]'s trained
    decoder) on [knobs_dropped]'s final map: the tp decoder on TP_ROWS rows
    within TP_DEC_TOL of one process's; TP_STEPS steps over TP_RAYS rays of
    its last frame at the mapper's sample count, the same jitter on every
    dp rank (as JAX's replicated key draws it). Checks: the ranks hold the
    same packed table, pose and replicated decoder leaves where JAX's
    devices do (a tp column's dp replicas always; the replicated leaves on
    every rank after step 1; JAX's tp ranks of a row part on the table and
    the pose, as the port's do: printed); each rank's loss within
    TP_LOSS_RTOL and its pose within 2 x TP_STEPS x lr_pose of the same
    steps in one process (dp = tp = 1, the same jitter for every ray);
    K9a, K9b, K8 and K2 launched on every rank. Returns {"tp rank r":
    launches}."""
    gen = torch.Generator().manual_seed(5)
    idx, rvalid = sample_ray_indices(inp["valid"], TP_RAYS, gen)
    x = torch.randn((TP_ROWS, 16), generator=gen) * 0.1
    dp, _ = sharding.mesh_shape(TP_RANKS)
    u_local = raycast.uniform_jitter((TP_RAYS // dp, inp["rc"].n_samples), gen, "cpu")
    inputs = {**{k: inp[k] for k in ("map_cfg", "rc", "state", "decoder", "pose6", "crit",
                                     "lrs")},
              "x": x, "pts": inp["points"][idx].contiguous(), "cos": inp["cos"][idx].contiguous(),
              "val": rvalid.contiguous(), "u": u_local, "dp": dp, "steps": TP_STEPS}
    t0 = time.perf_counter()
    ranks = sharding.spawn(tp_rank, TP_RANKS, [device] * TP_RANKS, "gloo", (inputs,))
    wall = time.perf_counter() - t0
    # the comparison in this process over all the rays, each dp block's rays
    # taking the jitter the ranks share: its launches are not the path's
    one = {"steps": tp_steps(
        inputs, sharding.Mesh(1, 1, 0, 0), vm.MapState(*[t.to(device) for t in inputs["state"]]),
        {k: [t.to(device) for t in v] for k, v in inputs["decoder"].items()}, slice(None),
        inputs["u"].repeat(dp, 1))}
    tp_ = ranks[0]["mesh"][1]
    for r in ranks:
        log(f"[tp] rank {r['mesh']}: decoder on {TP_ROWS} rows within {r['dec_err']:.3g} of one "
            f"process (limit {TP_DEC_TOL:g}); losses {[round(s['loss'], 6) for s in r['steps']]};"
            f" {r['seconds']:.2f} s for {TP_STEPS} steps; launches {r['launches']}")
    lr_pose = inputs["lrs"][2]
    pose_tol = 2 * TP_STEPS * lr_pose
    gaps = [float(np.abs(r["steps"][-1]["pose"] - one["steps"][-1]["pose"]).max()) for r in ranks]
    lgaps = [abs(r["steps"][-1]["loss"] - one["steps"][-1]["loss"]) / abs(one["steps"][-1]["loss"])
             for r in ranks]
    log(f"[tp] {TP_RANKS} ranks (dp {ranks[0]['mesh'][0]} x tp {tp_}) on one card: {wall:.2f} s "
        f"wall (spawn, rendezvous and the decoder check included); after {TP_STEPS} steps the "
        f"pose within {max(gaps):.3g} of one process's (limit {pose_tol:g}), the loss within "
        f"{max(lgaps):.3g} relative (limit {TP_LOSS_RTOL:g}); one process's losses "
        f"{[round(s['loss'], 6) for s in one['steps']]}")
    for r in ranks:
        check(r["dec_err"] <= TP_DEC_TOL, f"[tp] rank {r['mesh']} decoder error {r['dec_err']}")
    for k in range(TP_STEPS):
        for r in ranks:
            q = ranks[r["mesh"][3]]  # the dp replica in row 0 of this rank's tp column
            check(r["steps"][k]["packed"] == q["steps"][k]["packed"]
                  and np.array_equal(r["steps"][k]["pose"], q["steps"][k]["pose"]),
                  f"[tp] step {k}: rank {r['mesh']} differs from its tp column's dp replica")
        check(all(r["steps"][0]["replicated"] == ranks[0]["steps"][0]["replicated"]
                  for r in ranks), "[tp] step 1: the replicated decoder leaves differ")
    parted = [k for k in range(TP_STEPS)
              if ranks[0]["steps"][k]["packed"] != ranks[1]["steps"][k]["packed"]]
    log(f"[tp] the tp ranks of a row part on the packed table after steps {parted} (JAX's "
        "devices do: their pose and table gradients are each rank's column block's share)")
    check(max(gaps) <= pose_tol, f"[tp] pose {max(gaps)} from one process's")
    check(max(lgaps) <= TP_LOSS_RTOL, f"[tp] loss {max(lgaps)} from one process's")
    for r in ranks:
        for k_ in ("march_occupancy", "place_samples_cdf", "active_field_fwd", "hits_field_bwd"):
            check(r["launches"][k_] > 0, f"kernel {k_} never launched on [tp] rank {r['mesh']}")
    return {f"tp rank {i}": r["launches"] for i, r in enumerate(ranks)}


def exact_checks(tag, slam, launches, n_frames):
    """The exact-gradient path's launches: a step's E1 lists built once,
    E1's transpose on every BA iteration and its forward on every
    iteration and once after the loop, one K9a march and one K9b placement
    on every BA iteration (no superset), K9a on every tracker iteration
    with ``resample_rays`` (the Adam tracker's); no K5 and no update count
    (no voxel is marked touched)."""
    steps, n_it = launches["pack_embeddings_vjp_build"], slam.bp_current.num_iterations
    ba_it = steps * n_it
    track_it = (slam.tp_first.num_iterations + (n_frames - 2) * slam.tp.num_iterations
                if slam.track_method == "adam" and slam.tp.resample_rays else 0)
    march, place = launches["march_occupancy"], launches["place_samples_cdf"]
    log(f"{tag} exact: {steps} BA steps x {n_it} iterations; E1 transpose "
        f"{launches['pack_embeddings_vjp']}, forward {launches['pack_embeddings']}, K9a {march}, "
        f"K9b {place}, K5 {launches['reconcile']}; tracker iterations with a fresh march: "
        f"{track_it} at least")
    check(steps > 0 and launches["pack_embeddings_vjp"] == ba_it,
          f"E1's transpose launched {launches['pack_embeddings_vjp']} times for {ba_it} BA "
          "iterations")
    check(launches["pack_embeddings"] == steps * (n_it + 1),
          f"E1's forward launched {launches['pack_embeddings']} times for {steps} steps")
    check(march >= ba_it + track_it, f"K9a launched {march} times for {ba_it} BA and "
          f"{track_it} tracker iterations")
    if track_it:  # a march and a placement on every iteration of both
        check(place == march, f"K9b launched {place} times, K9a {march}")
    check(launches["reconcile"] == 0, "K5 launched on the exact path")
    check(int(slam.state.map_state.upd_count.sum()) == 0, "an update count on the exact path")
    check(slam.overflow_events["touched"] == 0, "a touched overflow on the exact path")


def drift_lat_cm_f(est, gt):
    """Mean lateral per-frame drift (cm/frame), scripts/eval_replica.py:99-111."""
    rel_e = np.linalg.inv(est[:-1]) @ est[1:]
    rel_g = np.linalg.inv(gt[:-1]) @ gt[1:]
    diff = rel_e[:, :3, 3] - rel_g[:, :3, 3]
    fwd = rel_g[:, :3, 3] / (np.linalg.norm(rel_g[:, :3, 3], axis=1, keepdims=True) + 1e-9)
    along = np.einsum("ij,ij->i", diff, fwd)
    return float(np.linalg.norm(diff - along[:, None] * fwd, axis=1).mean()) * 100


def checkpoint_phase(cfg, ds, workdir, name="kitti_quality"):
    """Checkpoint and resume on a quality config: frames 0 to CKPT_FRAME,
    save, load into a fresh object, compare all that was saved, then the
    remaining frames and finalize from the loaded object, its ATE held to
    the config's bound. Under defer_sync the save drains the frame in
    flight, and the device pose recurrence comes back equal."""
    tag = f"[checkpoint {name}]"
    a = NerfLoamSLAM_torch(cfg, ds, device="cuda")
    frames = make_frames(a, ds)
    a.process_first_frame(frames[0])
    for f in frames[1:CKPT_FRAME + 1]:
        a.process_frame(f)
    path = os.path.join(workdir, "ckpt", name, f"{CKPT_FRAME:05d}")
    t0 = time.perf_counter()
    save_checkpoint(path, a)
    t_save = time.perf_counter() - t0
    b = NerfLoamSLAM_torch(cfg, ds, device="cuda")
    t0 = time.perf_counter()
    load_checkpoint(path, b)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    sa, sb = a.state, b.state
    for nm in vm.MapState._fields:
        if nm not in DERIVED_MAP_FIELDS:
            check(torch.equal(getattr(sa.map_state, nm), getattr(sb.map_state, nm)),
                  f"checkpoint: map table {nm} differs")
    for nm in DERIVED_MAP_FIELDS:  # rebuilt from the saved tables on both sides
        check(torch.equal(getattr(sa.map_state, nm), getattr(sb.map_state, nm)),
              f"checkpoint: derived table {nm} differs")
    for k in ("w", "b"):
        check(all(torch.equal(x, y) for x, y in zip(sa.decoder_params[k], sb.decoder_params[k])),
              f"checkpoint: decoder {k} differs")
    check(len(sa.keyframes) == len(sb.keyframes) > 0, "checkpoint: keyframe count differs")
    for ka, kb in zip(sa.keyframes, sb.keyframes):
        check(ka.index == kb.index and ka.n_points == kb.n_points
              and all(np.array_equal(getattr(ka, n), getattr(kb, n))
                      for n in ("points", "points_cos", "valid", "pose6")),
              "checkpoint: a keyframe differs")
    check(sa.keyframes.index(sa.current_keyframe) == sb.keyframes.index(sb.current_keyframe),
          "checkpoint: the current keyframe differs")
    check((a.bp_current.touched_cap, a.bp_random.touched_cap, a.insert_cand_cap, a.map_cfg)
          == (b.bp_current.touched_cap, b.bp_random.touched_cap, b.insert_cand_cap, b.map_cfg),
          "checkpoint: budgets differ")
    check(torch.equal(a.generator.get_state(), b.generator.get_state()),
          "checkpoint: the device generator's state differs")
    check(a.pyrng.getstate() == b.pyrng.getstate(), "checkpoint: the host generator differs")
    check(a._inflight is None and b._inflight is None, "checkpoint: a frame in flight")
    for nm in ("_dev_last_pose6", "_dev_prev_pose6"):  # defer_sync's; None when synchronous
        pa, pb = getattr(a, nm), getattr(b, nm)
        check((pa is None and pb is None) if not a.defer_sync
              else (pa is not None and pb is not None and torch.equal(pa, pb)),
              f"checkpoint: {nm} differs")
    check(np.array_equal(a.sdf_bias, b.sdf_bias) and np.array_equal(sa.rel_pose, sb.rel_pose)
          and sa.frames_processed == sb.frames_processed == CKPT_FRAME + 1
          and np.array_equal(sa.last_frame.pose6, sb.last_frame.pose6)
          and len(sa.frame_poses) == len(sb.frame_poses),
          "checkpoint: bookkeeping differs")
    size_mb = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 1e6
    log(f"{tag} saved after frame {CKPT_FRAME} in {t_save:.2f} s ({size_mb:.1f} MB), loaded in "
        f"{t_load:.2f} s; map tables, decoder, {len(sb.keyframes)} keyframes, budgets and both "
        "generator states equal" + ("; the device pose recurrence equal: last "
                                   f"{b._dev_last_pose6.tolist()}" if a.defer_sync else ""))
    del a
    for f in frames[CKPT_FRAME + 1:]:
        b.process_frame(f)
    poses = np.asarray(b.finalize())
    torch.cuda.synchronize()
    gt = ds.gt_trajectory()[: len(poses)]
    ate = ate_rmse(poses, gt, align=False)
    log(f"{tag} resumed frames {CKPT_FRAME + 1}-{len(frames) - 1} + finalize: {len(poses)} poses, "
        f"ATE {ate:.4f} m (bound {ate_bound(name):.4f} m)")
    check(len(poses) == len(frames) and np.isfinite(poses).all(), "resumed run lost poses")
    check(b.dropped_delta_events == 0, "dropped deltas in the resumed run")
    check(b._inflight is None, "a frame in flight after the resumed run's finalize")
    check(ate <= ate_bound(name), f"resumed ATE {ate} above bound ({name})")
    return ate


def sync_sites(slam, frame):
    """The synchronizing CUDA calls of one frame (``process_frame``: under
    defer_sync the frame's dispatch and the previous frame's finalize) by
    site, from torch.cuda.set_sync_debug_mode("warn"): the innermost frame
    of the repository's code on each warning's stack, with its caller
    (outside the repository: the stack's last three frames). ``frame``
    None: the mode switched on and off around nothing, what the switch
    itself reports."""
    here = os.path.dirname(os.path.abspath(__file__))
    sites = Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        full = [f for f in traceback.extract_stack()[:-1] if "/warnings.py" not in f.filename]
        stack = [f for f in full
                 if f.filename.startswith(here) and not f.filename.endswith("chip_smoke.py")]
        where = [f"{os.path.relpath(f.filename, here) if f.filename.startswith(here) else f.filename}"
                 f":{f.lineno} ({f.name})" for f in (stack[-2:] or full[-3:])]
        sites[" < ".join(reversed(where))] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            if frame is not None:
                slam.process_frame(frame)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites


def defer_phase(cfg, ds):
    """Two checks of the deferred schedule on kitti_quality_defer:
    [defer] syncs, the synchronizing calls of a steady frame by site;
    [defer] fetch, that a finalize waits for its own frame's staged
    outputs alone: a frame is dispatched and its outputs copied out, a
    DEFER_SLEEP_MS device sleep is enqueued behind it, and finalize must
    return while the stream is still busy (a blocking read would have
    waited for the sleep)."""
    slam = NerfLoamSLAM_torch(cfg, ds, device="cuda")
    frames = make_frames(slam, ds, WARMUP_FRAMES + 2)
    slam.process_first_frame(frames[0])
    for f in frames[1:WARMUP_FRAMES]:
        slam.process_frame(f)
    empty = sync_sites(slam, None)
    sites = sync_sites(slam, frames[WARMUP_FRAMES])
    log(f"[defer] syncs: {sum(sites.values())} synchronizing calls in frame {WARMUP_FRAMES}'s "
        f"process_frame (its dispatch, frame {WARMUP_FRAMES - 1}'s finalize), by site; the mode "
        f"switched on and off around nothing reports {sum(empty.values())} "
        f"({', '.join(empty) or 'none'}):")
    for site, n in sites.most_common():
        log(f"[defer] syncs   {n:3d}  {site}")
    slam._drain()
    torch.cuda.synchronize()
    # the device sleep's cycles for DEFER_SLEEP_MS, from one timed sleep
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    torch.cuda._sleep(10_000_000)
    e1.record()
    e1.synchronize()
    cycles = int(10_000_000 * DEFER_SLEEP_MS / e0.elapsed_time(e1))
    f = frames[WARMUP_FRAMES + 1]
    update_decoder = (f.index - slam.state.first_frame_id) < slam.freeze_frame
    rec = slam._mega_dispatch(f, slam._mapper_copy(f), update_decoder)
    rec.outs.event.synchronize()  # its outputs are on the host
    e0.record()
    torch.cuda._sleep(cycles)  # the work of a newer frame, queued behind it
    t0 = time.perf_counter()
    slam._mega_finalize(rec)
    t_fin = (time.perf_counter() - t0) * 1e3
    busy = not torch.cuda.current_stream().query()
    e1.record()
    e1.synchronize()
    log(f"[defer] fetch: finalize of frame {f.index} took {t_fin:.3f} ms on the host while a "
        f"{e0.elapsed_time(e1):.1f} ms device sleep ran behind the frame; the stream was "
        f"{'still busy' if busy else 'idle'} when it returned; pose {f.pose6[:3].tolist()}")
    check(busy, "[defer] fetch: finalize waited for the work queued after its frame")
    check(np.isfinite(f.pose6).all() and len(slam.state.frame_telemetry) == WARMUP_FRAMES + 1,
          "[defer] fetch: the finalized frame's bookkeeping is missing")
    return sites


def pair_run(cfg, ds):
    """One 30-frame run of a config without a logger, timed as main_path
    times it: scans/s over frames WARMUP_FRAMES to the end (the last
    frame's finalize inside the window), host CPU s a frame, the ``sync``
    section's mean ms (a finalize's wait for its outputs) and host syncs a
    frame."""
    slam = NerfLoamSLAM_torch(cfg, ds, device="cuda")
    frames = make_frames(slam, ds)
    slam.process_first_frame(frames[0])
    for f in frames[1:WARMUP_FRAMES]:
        slam.process_frame(f)
    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), time.process_time()
    for f in frames[WARMUP_FRAMES:]:
        slam.process_frame(f)
    slam._drain()
    torch.cuda.synchronize()
    dt, cpu = time.perf_counter() - t0, time.process_time() - c0
    slam.finalize()
    n = len(frames) - WARMUP_FRAMES
    return {"scans": n / dt, "cpu": cpu / n, "sync_ms": slam.prof.summary()["sync"]["mean_ms"],
            "syncs": slam.host_syncs / len(frames)}


def defer_pairs(cfgs, ds):
    """[defer] pairs: kitti_quality and kitti_quality_defer in turns (sync,
    then defer: one pair, cut from two to make room for [trig] and [dp]) in
    one call; printed, not gated."""
    runs = []
    for name in ("kitti_quality", "kitti_quality_defer"):
        r = pair_run(cfgs[name], ds)
        runs.append((name, r))
        log(f"[defer] pairs {name}: {r['scans']:.4f} scans/s, host CPU {r['cpu']:.4f} s a frame, "
            f"sync section {r['sync_ms']:.3f} ms, host syncs {r['syncs']:.2f} a frame")
        torch.cuda.empty_cache()
    return runs



def profile_phase(label, cfg, ds, n_frames=8, n_profiled=3, device="cuda"):
    """torch.profiler over a few steady frames of a fresh run: device time
    by kernel, the port kernels' device time per launch on the path, and
    the device's busy share of the window. Only the device activity is
    traced: the host's op events, which nothing here reads, made most of
    the phase's time in their processing."""
    from torch.profiler import ProfilerActivity, profile

    slam = NerfLoamSLAM_torch(cfg, ds, device=device)
    frames = []
    for i in range(n_frames):
        idx, pts, cos, _ = ds[i]
        frames.append(Frame.from_raw(idx, pts, cos, None, slam.points_pad))
    frames[0].pose6 = pose6_from_matrix_np(ds.get_init_pose(0))
    slam.process_first_frame(frames[0])
    for f in frames[1:-n_profiled]:
        slam.process_frame(f)
    torch.cuda.synchronize()
    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        for f in frames[-n_profiled:]:
            slam.process_frame(f)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_PAD_S)
    averages = prof.key_averages()
    t_prof = time.perf_counter() - t_prof
    events = [e for e in averages if _on_device(e)]
    dev = lambda e: getattr(e, "self_device_time_total", 0.0) / 1e3  # noqa: E731
    total = sum(dev(e) for e in events)
    tag = f"[profile {label}]"
    log(f"{tag} {n_profiled} frames: wall {wall_ms:.1f} ms (profiler on), device kernels "
        f"{total:.1f} ms, busy share {total / wall_ms:.3f}, {sum(e.count for e in events)} "
        f"kernel launches; the profiler's window and processing {t_prof:.1f} s")
    per_frame = (sum(e.count for e in events) / n_profiled, total / n_profiled)
    log(f"{tag} per frame: {per_frame[0]:.1f} device launches, {per_frame[1]:.2f} device ms")
    for e in sorted(events, key=dev, reverse=True)[:15]:
        log(f"{tag} {dev(e) / n_profiled:9.3f} ms/frame  {e.count / n_profiled:8.1f}/frame  "
            f"{e.key[:90]}")
    # the port's own kernels (csrc/*.cu): device time per launch on the path
    for fn, (t, n) in sorted(port_kernel_times(averages).items(), key=lambda kv: -kv[1][0]):
        log(f"{tag} port kernel {fn}: {t / 1e3 / n_profiled:.4f} ms/frame, "
            f"{n / n_profiled:.1f} launches/frame, {t / n:.2f} us/launch (device)")
    return per_frame


def gate_path(here, seed, exact=False):
    """The replica gate's main path for one data seed (``exact``: with the
    reference-exact fallbacks); (its config, its dataset, main_path's
    result)."""
    cfg = load_cfg(here, "replica_gate60", seed=seed, exact=exact)
    ds = get_dataset(cfg)
    result = main_path("replica_gate60", NerfLoamSLAM_torch(cfg, ds, device="cuda"), ds,
                       label=f"replica_gate60{'_exact' if exact else ''}_s{seed}")
    torch.cuda.empty_cache()
    return cfg, ds, result


def spread_draw(here, ts):
    """One draw of the exact gate (data seed 0, generator seed ``ts``) in a
    worker process of gate_spread: (raw ATE, aligned ATE, every pose there
    and finite, dropped delta events)."""
    torch.set_num_threads(2)
    cfg = load_cfg(here, "replica_gate60", seed=0, exact=True, tpu_seed=ts)
    ds = get_dataset(cfg)
    slam = NerfLoamSLAM_torch(cfg, ds, device="cuda")
    frames = make_frames(slam, ds)
    slam.process_first_frame(frames[0])
    for f in frames[1:]:
        slam.process_frame(f)
    poses = np.asarray(slam.finalize())
    gt = ds.gt_trajectory()[:len(poses)]
    return (ate_rmse(poses, gt, align=False), ate_rmse(poses, gt, align=True),
            len(poses) == len(frames) and bool(np.isfinite(poses).all()),
            slam.dropped_delta_events)


def gate_spread(here, first):
    """The exact replica gate (data seed 0) over GATE60_SPREAD_SEEDS, the
    random stream's seeds (``tpu_specs.seed``; ``first``: main_path's ATE
    of the config's own seed, the first of them): one run's raw ATE is a
    draw (over these seeds JAX's default gate crosses 0.27 m twice, at 786
    and 790, the port's three times), so the raw ATE is held to the gate's
    0.27 m on the median of the draws, and that median to JAX's median
    over the same seeds (max(1.5 x, + 0.05 m); JAX's own exact gate
    crosses 0.27 m there once, at 790, with 0.8875 m); every draw's aligned
    ATE to the gate's 0.17 m. Each draw is printed. The draws run in
    SPREAD_WORKERS processes side by side on the card, the config's own
    seed among them: its draw must repeat main_path's to the last digit."""
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            SPREAD_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        draws = list(pool.map(partial(spread_draw, here), GATE60_SPREAD_SEEDS))
    for ts, (raw, al, ok, dropped) in zip(GATE60_SPREAD_SEEDS, draws):
        log(f"[gate spread] replica_gate60_exact_s0, generator seed {ts}: ATE raw {raw:.4f} m, "
            f"aligned {al:.4f} m")
        check(ok, f"gate spread: seed {ts} lost poses")
        check(dropped == 0, f"gate spread: dropped deltas at seed {ts}")
    check(draws[0][:2] == (first["raw"], first["aligned"]),
          f"gate spread: the draw at seed {GATE60_SPREAD_SEEDS[0]} ({draws[0][:2]}) differs from "
          f"the main path's ({first['raw']}, {first['aligned']})")
    raws, aligned = [d[0] for d in draws], [d[1] for d in draws]
    med, jmed = float(np.median(raws)), float(np.median(GATE60_EXACT_JAX_RAW))
    bound_ = max(1.5 * jmed, jmed + 0.05)
    log(f"[gate spread] {len(raws)} generator seeds in {time.perf_counter() - t0:.1f} s "
        f"({SPREAD_WORKERS} processes; seed {GATE60_SPREAD_SEEDS[0]} repeats the main path's "
        f"digits): raw ATE median {med:.4f} m (gate "
        f"{GATE60_ATE_RAW_MAX}; JAX's median {jmed:.4f} m over the same seeds, bound "
        f"{bound_:.4f} m), {sum(r >= GATE60_ATE_RAW_MAX for r in raws)} draws at or over "
        f"{GATE60_ATE_RAW_MAX} m (JAX: {sum(r >= GATE60_ATE_RAW_MAX for r in GATE60_EXACT_JAX_RAW)}); "
        f"aligned max {max(aligned):.4f} m (gate {GATE60_ATE_ALIGNED_MAX})")
    check(max(aligned) < GATE60_ATE_ALIGNED_MAX,
          f"gate spread: aligned ATE {max(aligned)} not under {GATE60_ATE_ALIGNED_MAX}")
    check(med < GATE60_ATE_RAW_MAX and med <= bound_,
          f"gate spread: median raw ATE {med} not under {GATE60_ATE_RAW_MAX} or above {bound_}")
    return {"median_raw": med, "jax_median_raw": jmed, "raw": raws, "aligned": aligned}


def kitti_paths(names, cfgs, ds, workdir):
    """The KITTI configs' main paths in turn, those of LOGGED with a
    RunLogger in ``workdir``; {name: main_path's result}. The mapping-only
    path reads its own dataset (the same frames with their GT poses)."""
    results = {}
    for n in names:
        logger = RunLogger(workdir, n, config=cfgs[n].as_dict()) if n in LOGGED else None
        d = get_dataset(cfgs[n]) if cfgs[n].data_specs.get("use_gt", False) else ds
        results[n] = main_path(n, NerfLoamSLAM_torch(cfgs[n], d, device="cuda", logger=logger), d)
        torch.cuda.empty_cache()
    if "kitti_quality" in results and "kitti_quality_defer" in results:
        compare_defer(results["kitti_quality"], results["kitti_quality_defer"])
    return results


RUNNER_PHASES = ("loader", "subscene", "sequences", "dp", "knobs_dropped", "tp")


def runner_phases(here, names, cfgs, ds, workdir, stamp):
    """The host data path and the runners over several pipelines, each
    phase's launch counts zeroed before it and read after: {phase: counts}.
    [tp] runs on [knobs_dropped]'s final map (which it runs first when it
    is asked for alone)."""
    out, tp_input = {}, None
    for name in names:
        if name == "loader":
            out[name] = loader_phase(cfgs["kitti_quality"], ds, workdir)
        elif name == "subscene":
            out[name] = subscene_phase(cfgs["kitti_quality"], ds)
        elif name == "dp":
            out.update(dp_phase(here))
        elif name == "knobs_dropped":
            out[name], tp_input = knobs_dropped_phase(here)
        elif name == "tp":
            if tp_input is None:
                _, tp_input = knobs_dropped_phase(here)
            out.update(tp_phase(tp_input))
        else:
            out[name] = sequences_phase(here)
        gc.collect()
        torch.cuda.empty_cache()
        stamp(f"[{name}]")
    return out


def compare_defer(sync, defer):
    """The deferred quality run beside the synchronous one: keyframes, the
    trajectories' difference and the bias target (printed, not gated: the
    schedules differ by design, keyframes and the bias EMA act a frame
    later under defer_sync)."""
    a, b = sync[4], defer[4]
    d = np.linalg.norm(a["poses"][:, :3, 3] - b["poses"][:, :3, 3], axis=1)
    log(f"[defer] kitti_quality vs kitti_quality_defer: keyframes {a['keyframes']} / "
        f"{b['keyframes']}; trajectory difference {ate_rmse(b['poses'], a['poses'], align=False):.4f}"
        f" m RMSE, {d.max():.4f} m at most; ATE {sync[3]['raw']:.4f} / {defer[3]['raw']:.4f} m; "
        f"sdf_bias {a['sdf_bias']} / {b['sdf_bias']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Smoke test of the port on one NVIDIA GPU.")
    ap.add_argument("--paths", help="comma-separated main paths (kitti_budget, kitti_quality, "
                    "kitti_adam25, kitti_quality_s2s, kitti_exact, kitti_knobs, "
                    "kitti_mapping_gt, kitti_decoder_pe, kitti_quality_defer, "
                    "kitti_budget_defer_grow, replica_gate60_s<seed>, "
                    "replica_gate60_exact_s<seed>), defer phases (defer_checks: [defer] "
                    "syncs, [defer] fetch and the defer checkpoint; defer_pairs) and the host "
                    "data path, the runners and the layouts (loader, subscene, sequences, dp, "
                    "knobs_dropped, tp; loader_pairs: the two loaders' runs in ten pairs in "
                    "turns): run only those")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    t_run = time.perf_counter()

    def stamp(phase):
        log(f"[time] {phase} done {time.perf_counter() - t_run:.1f} s from the start")

    device_kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {device_kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")

    t0 = time.perf_counter()
    kernels.lib()
    log(f"[build] {len(kernels.build_info.get('built', []))} sources built in parallel and "
        f"loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc wall {kernels.build_info.get('seconds', 0.0):.2f} s)")
    for src, out in kernels.build_info.get("log", {}).items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")

    kitti = ("kitti_budget", "kitti_quality", "kitti_adam25", "kitti_quality_s2s", "kitti_exact",
             "kitti_knobs", "kitti_mapping_gt", "kitti_decoder_pe") + DEFER_PATHS
    cfgs = {n: load_cfg(here, n) for n in kitti}
    ds = get_dataset(cfgs["kitti_quality"])  # the KITTI-budget configs share the data
    if args.paths:
        names = args.paths.split(",")
        with tempfile.TemporaryDirectory() as workdir:
            kitti_paths([n for n in names if n in kitti], cfgs, ds, workdir)
            if "defer_checks" in names:
                defer_phase(cfgs["kitti_quality_defer"], ds)
                checkpoint_phase(cfgs["kitti_quality_defer"], ds, workdir, "kitti_quality_defer")
            runner_phases(here, [n for n in names if n in RUNNER_PHASES], cfgs, ds, workdir,
                          stamp)
        if "defer_pairs" in names:
            defer_pairs(cfgs, ds)
        if "loader_pairs" in names:
            with tempfile.TemporaryDirectory() as workdir:
                loader_pairs(cfgs["kitti_quality"], ds, workdir)
        log(f"[time] the whole script {time.perf_counter() - t_run:.1f} s")
        for n in names:
            if n.startswith("replica_gate60_s"):
                gate_path(here, int(n[len("replica_gate60_s"):]))
            if n.startswith("replica_gate60_exact_s"):
                gate_path(here, int(n[len("replica_gate60_exact_s"):]), exact=True)
        return 0
    gate = {s_: load_cfg(here, "replica_gate60", seed=s_) for s_ in GATE60_SEEDS}
    gate_slam = NerfLoamSLAM_torch(gate[0], None, device="cuda")
    loops = {"adam25": NerfLoamSLAM_torch(cfgs["kitti_adam25"], None,
                                          device="cuda").tp.num_iterations,
             "gate60": gate_slam.bp_current.num_iterations}
    sp = NerfLoamSLAM_torch(cfgs["kitti_quality_s2s"], None, device="cuda").tp.s2s
    e1_shapes = {"kitti_exact": NerfLoamSLAM_torch(cfgs["kitti_exact"], None, device="cuda"),
                 "gate60": gate_slam}
    e1_shapes = {k: (v.map_cfg.capacity, vm.acap(v.map_cfg)) for k, v in e1_shapes.items()}
    records = kernel_phase(NerfLoamSLAM_torch(cfgs["kitti_quality"], ds, device="cuda"), ds,
                           gate_slam.rc_map, (gate_slam.tp.n_rays, gate_slam.rc_track.n_samples),
                           loops, sp, e1_shapes)
    del gate_slam
    gc.collect()  # hand the kernel phase's freed blocks back before the timed paths
    torch.cuda.empty_cache()
    stamp("the kernel phase")
    add_device_times(records)
    stamp("the kernel-phase calls profiled")
    with tempfile.TemporaryDirectory() as workdir:
        results = kitti_paths(kitti, cfgs, ds, workdir)
        track = {n: results[n][2]["track"]["mean_ms"]
                 for n in ("kitti_quality", "kitti_quality_s2s")}
        log(f"[s2s] tracker ms per frame: quality {track['kitti_quality']:.3f}, quality + s2s "
            f"{track['kitti_quality_s2s']:.3f}; the s2s term adds "
            f"{track['kitti_quality_s2s'] - track['kitti_quality']:.3f} ms")
        resumed_ate = checkpoint_phase(cfgs["kitti_quality"], ds, workdir)
        torch.cuda.empty_cache()
        defer_phase(cfgs["kitti_quality_defer"], ds)
        resumed_defer_ate = checkpoint_phase(cfgs["kitti_quality_defer"], ds, workdir,
                                             "kitti_quality_defer")
        torch.cuda.empty_cache()
    pairs = defer_pairs(cfgs, ds)
    gaussian_ate = gaussian_run(here, ds)
    torch.cuda.empty_cache()
    stamp("the KITTI paths and the checkpoint")
    with tempfile.TemporaryDirectory() as workdir:
        phase_launches = runner_phases(here, RUNNER_PHASES, cfgs, ds, workdir, stamp)
    gate_ds = {}
    for s_ in GATE60_SEEDS:
        _, gate_ds[s_], results[f"replica_gate60_s{s_}"] = gate_path(here, s_)
    _, _, results["replica_gate60_exact_s0"] = gate_path(here, 0, exact=True)
    spread = gate_spread(here, results["replica_gate60_exact_s0"][3])
    stamp("the gate paths and the spread")
    per_frame = {label: profile_phase(label, cfg, d) for label, cfg, d in (
        ("kitti_budget", cfgs["kitti_budget"], ds), ("kitti_quality", cfgs["kitti_quality"], ds),
        ("kitti_quality_s2s", cfgs["kitti_quality_s2s"], ds),
        ("kitti_adam25", cfgs["kitti_adam25"], ds), ("replica_gate60_s0", gate[0], gate_ds[0]),
        ("kitti_exact", cfgs["kitti_exact"], ds),
        ("kitti_quality_defer", cfgs["kitti_quality_defer"], ds))}
    log("[result] per frame (profile, 3 steady frames): " + ", ".join(
        f"{n} {v[0]:.1f} device launches, {v[1]:.2f} device ms" for n, v in per_frame.items()))
    log("[result] ATE (m): " + ", ".join(
        f"{n} " + " / ".join(f"{k} {a:.4f}" for k, a in v[3].items()) for n, v in results.items())
        + f", kitti_quality resumed {resumed_ate:.4f}, kitti_quality_defer resumed "
        f"{resumed_defer_ate:.4f}, replica_gate60_exact_s0 median raw over "
        f"{len(spread['raw'])} generator seeds {spread['median_raw']:.4f}, kitti_budget gaussian "
        f"{GAUSSIAN_FRAMES} frames {gaussian_ate:.4f}")
    stamp("the frame profiles")
    path_launches = {**{n: results[n][0] for n in results}, **phase_launches}
    for r in records:
        by_path = {n: c[r["name"]] for n, c in path_launches.items()}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
        if r["name"] in UNDONE_BY:  # K7's undo: only where a frame overflowed and replayed
            r["undo_launches"] = sum(c["undo_insert"] for c in path_launches.values())
        if r["name"] == "pack_embeddings_vjp":  # its lists, built once a BA step
            r["build_launches"] = sum(c["pack_embeddings_vjp_build"]
                                      for c in path_launches.values())
    log(f"[result] scans/s " + ", ".join(f"{n} {v[1]:.4f}" for n, v in results.items())
        + f" on {smi}")
    for cfg_name, r in pairs:  # the device's busy share: the profile's device ms a frame x scans/s
        ms_frame = per_frame[cfg_name][1]
        log(f"[defer] pairs {cfg_name}: busy share {ms_frame * r['scans'] / 1e3:.3f} "
            f"({ms_frame:.2f} device ms a frame x {r['scans']:.4f} scans/s)")
    log(f"[time] the whole script {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
