"""defer_sync in the port, on the CPU: the deferred schedule of
NerfLoamSLAM_torch (frame k dispatched before frame k-1 is finalized),
against the port's own synchronous schedule and against the JAX
package's pieces.

- The device warm start ``_const_vel`` against JAX's ``_const_vel_jit``.
- Quiesced (no keyframe event, no bias transfer, the same checkpoint
  interval): the synchronous and the deferred run fetch the same row,
  active and candidate counts frame by frame (the newer frame's insert
  writes the counters in place: a fetch made at finalize instead of at
  dispatch would read the newer frame's), their trajectories agree to
  1e-3 m (only the warm start's rounding differs), and their telemetry and
  keyframe counts are equal. Each deferred dispatch hands the megastep
  the previous frame's tracked pose from the device (the s2s term's
  previous scan and ``ba_pose_project=along`` read it), before that frame
  is finalized, and the Adam learning rate of the synchronous run.
- An active set that overflows with a newer frame in flight: both inserts
  undone, the older frame replayed at the grown budget and the newer on
  top, nothing dropped, the trajectory within 1e-5 m of the roomy run's
  (tests/test_torch_overflow.py's tolerance for an active-set growth).
- Resume from a checkpoint the deferred run wrote: bit for bit the
  save-and-continue run, the device pose recurrence restored.
The runs share the small slice's shapes at fewer iterations and six
frames; every run is the port's (twins on the CPU)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloam_tpu.core.pipeline import _const_vel_jit
from nerfloam_tpu.utils.config import load_config
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch, _const_vel
from nerfloam_tpu_torch.data import get_dataset
from nerfloam_tpu_torch.utils.checkpoint import load_checkpoint
from nerfloam_tpu_torch.utils.config import finalize, load_json_config
from nerfloam_tpu_torch.utils.evaluation import ate_rmse
from nerfloam_tpu_torch.utils.logger import RunLogger

from _canon import CANON

torch.set_num_threads(2)
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CFG_PATH = os.path.join(ROOT, "configs", "synthetic", "synthetic_small.yaml")
CKPT_FREQ = 2
N_FRAMES = 5
# the slice's shapes and schedule (tests/test_torch_pipeline.py) in a region
# 8 m high instead of 20 (the scene lies inside it: the same digits, a third
# of the grid to fill on the CPU), five frames, no final replay (it moves
# no pose)
QUIET = CANON + [
    f"data_specs.n_frames={N_FRAMES}", "tpu_specs.bootstrap_steps=6", "tpu_specs.sampler=hits",
    "tpu_specs.track_method=gn", "tpu_specs.recenter_margin=8.0", "tpu_specs.region_z_half=8.0",
    "mapper_specs.final_iter=false", "mapper_specs.keyframe_gap=100",
    "tpu_specs.bias_correction=false", f"debug_args.ckpt_freq={CKPT_FREQ}",
]
# above the first and second frames' active surface voxels (2,125 and
# 2,947), below the third's (3,554): the growth is found when frame 2 is
# finalized, with frame 3 in flight
SMALL_ACTIVE_CAP = 3072


def _run(overrides, log_dir):
    """A run of the port through ``run()``, with a RunLogger in ``log_dir``
    for its periodic checkpoints (which drain the frame in flight). Also
    returns the fetched (num_lat, n_active, num_cand) of every megastep as
    finalize read them, and per dispatch the frame, the previous pose the
    megastep was handed, whether the previous frame was finalized by then,
    and the Adam learning rate."""
    cfg = finalize(load_config(CFG_PATH, QUIET + overrides).as_dict())
    logger = RunLogger(log_dir, "run", config=cfg.as_dict())
    slam = NerfLoamSLAM_torch(cfg, get_dataset(cfg), device="cpu", logger=logger)
    counts, dispatches, collect, dispatch = [], [], slam._collect, slam._mega_dispatch
    telemetry = slam.state.frame_telemetry

    def collect_counts(staged):
        got = collect(staged)
        if len(got) == 9:  # a megastep's outputs
            counts.append(tuple(int(got[i]) for i in (3, 4, 6)))
        return got

    def record_dispatch(frame, mapper_frame, update_decoder):
        prev = slam.state.last_frame
        finalized = any(row[0] == prev.index for row in telemetry)
        rec = dispatch(frame, mapper_frame, update_decoder)
        dispatches.append((frame.index, prev, rec.args[-1], finalized, rec.args[1]))
        return rec

    slam._collect, slam._mega_dispatch = collect_counts, record_dispatch
    # the logger is here for its periodic checkpoints; finalize's meshes,
    # which nothing here reads, are left empty
    slam.extract_mesh = lambda *a, **k: (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    poses = np.asarray(slam.run())
    return slam, poses, counts, dispatches


@pytest.fixture(scope="module")
def quiet(tmp_path_factory):
    """{defer_sync: the quiesced run}."""
    return {defer: _run([f"tpu_specs.defer_sync={str(defer).lower()}"],
                        str(tmp_path_factory.mktemp(f"defer_{defer}")))
            for defer in (False, True)}


def _pose_pairs(seed: int, w_sigma: float, n: int = 1000):
    rng = np.random.default_rng(seed)
    prev = np.concatenate([rng.uniform(-50, 50, (n, 3)), rng.normal(0, w_sigma, (n, 3))], 1)
    step = np.concatenate([rng.normal(0, 1.0, (n, 3)), rng.normal(0, w_sigma, (n, 3))], 1)
    return (prev + step).astype(np.float32), prev.astype(np.float32)


@pytest.mark.parametrize("full", [True, False], ids=["full", "translation"])
@pytest.mark.parametrize("branch", ["series", "exact", "exact_small"])
def test_const_vel_matches_jax(branch, full):
    """1,000 seeded pose pairs, each through one call of JAX's
    ``_const_vel_jit`` (as its pipeline calls it) and of the port's
    ``_const_vel``. Rotations under 1e-4 rad take exp_so3's series branch,
    where the port's se3 is JAX's bit for bit (its matrix products and
    inverse are XLA's on the CPU): equal. Larger ones (sigma 0.8 rad) take
    its exact branch, where the sine (and the cosine past ~0.1 rad) rounds
    otherwise than XLA's, and the warm start composes that rotation twice:
    within 2 ulp of each pose's largest entry with the rotation moved, 3
    with the translation alone (measured: 2.0 and 3.0 here; 3.0 for both
    before the cosine was taken in float64 and rounded once). Exact-branch
    angles under 0.01 rad (sigma 1e-3), where that cosine is XLA's: the
    translation equal, the rotation within half an ulp of its largest
    entry and 99.9% of the poses bit-equal (measured: 0.5 and 0.0625 ulp,
    999 of 1,000 poses; torch's f32 cosine in its place fails the case)."""
    sigma = {"series": 3e-5, "exact": 0.8, "exact_small": 1e-3}[branch]
    last, prev = _pose_pairs(14, sigma)
    ref = np.stack([np.asarray(_const_vel_jit(jnp.asarray(a), jnp.asarray(b), full))
                    for a, b in zip(last, prev)])
    got = np.stack([_const_vel(torch.from_numpy(a), torch.from_numpy(b), full).numpy()
                    for a, b in zip(last, prev)])
    if branch == "series":
        np.testing.assert_array_equal(got, ref)
    elif branch == "exact":
        ulp = np.spacing(np.abs(ref).max(1, keepdims=True))
        bound = 2 if full else 3
        assert (np.abs(got - ref) <= bound * ulp).all(), (np.abs(got - ref) / ulp).max()
    else:
        assert np.abs(ref[:, 3:]).max() < 0.01 and np.linalg.norm(last[:, 3:], axis=1).min() > 1e-4
        np.testing.assert_array_equal(got[:, :3], ref[:, :3])
        ulp = np.spacing(np.abs(ref[:, 3:]).max(1, keepdims=True))
        assert (np.abs(got - ref)[:, 3:] <= 0.5 * ulp).all(), (np.abs(got - ref)[:, 3:] / ulp).max()
        assert (got == ref).all(1).mean() >= 0.999


@pytest.mark.parametrize("name, base, extra", [
    ("kitti_quality_defer", "kitti_quality", {}),
    ("kitti_budget_defer_grow", "kitti_budget", {"active_cap": None}),
])
def test_defer_jsons(name, base, extra):
    """The deferred paths' configs are their synchronous configs with
    defer_sync on (the growing budget config with a smaller active set),
    so that scripts/port_ate_reference.py --defer gives their bounds."""
    cfg = load_json_config(os.path.join(ROOT, "nerfloam_tpu_torch", "configs", f"{name}.json"))
    ref = load_json_config(os.path.join(ROOT, "nerfloam_tpu_torch", "configs", f"{base}.json"))
    got, want = cfg.as_dict(), ref.as_dict()
    assert got["tpu_specs"].pop("defer_sync") is True
    want["tpu_specs"].pop("defer_sync")
    for key in extra:
        assert got["tpu_specs"].pop(key) < want["tpu_specs"].pop(key)
    assert got == want
    with open(os.path.join(ROOT, "nerfloam_tpu_torch", "configs", f"{name}.json")) as f:
        assert json.load(f)["tpu_specs"]["defer_sync"] is True


def test_quiesced_defer_fetches_the_same_counts(quiet):
    """Every tracked frame's fetched row, active and candidate counts equal
    under both schedules; the trajectories within 1e-3 m; the same
    telemetry rows and keyframes; nothing in flight after finalize."""
    (s_sync, p_sync, c_sync, _), (s_def, p_def, c_def, _) = quiet[False], quiet[True]
    assert len(c_sync) == len(c_def) == N_FRAMES - 1 and c_def == c_sync, (c_sync, c_def)
    assert p_def.shape == p_sync.shape == (N_FRAMES, 4, 4)
    assert ate_rmse(p_def, p_sync, align=False) < 1e-3
    assert len(s_def.state.frame_telemetry) == len(s_sync.state.frame_telemetry) == N_FRAMES - 1
    assert len(s_def.state.keyframes) == len(s_sync.state.keyframes)
    assert s_def.defer_sync and not s_sync.defer_sync
    assert s_def._inflight is None and s_def._defer_replays == 0
    assert s_def._dev_last_pose6 is not None and s_sync._dev_last_pose6 is None


def test_deferred_dispatch_reads_the_device_pose(quiet):
    """Each deferred dispatch after the first tracked frame gets the
    previous frame's raw tracked pose as a device tensor, equal to the pose
    that frame's finalize later read, while that frame was still in flight
    (except after a checkpoint's drain); the synchronous run hands over the
    host pose of a finalized frame. The Adam learning rate follows the same
    frame count under both schedules."""
    (_, _, _, d_sync), (_, _, _, d_def) = quiet[False], quiet[True]
    assert [d[0] for d in d_def] == [d[0] for d in d_sync] == list(range(1, N_FRAMES))
    assert [d[4] for d in d_def] == [d[4] for d in d_sync]
    assert all(d[3] and d[2] is None for d in d_sync[1:])  # no s2s, no along: not made
    for index, prev, pose6, finalized, _ in d_def[1:]:
        np.testing.assert_array_equal(pose6.numpy(), prev.pose6)
        assert finalized == (prev.index == CKPT_FREQ + 1), (index, finalized)


def test_active_overflow_in_flight_replays_both_frames(quiet, tmp_path):
    """The deferred run at an active set that grows mid-run: the growth is
    found at a finalize with the newer frame in flight, both frames are
    replayed, and the trajectory stays within 1e-5 m of the roomy run."""
    slam, poses, _, _ = _run(["tpu_specs.defer_sync=true",
                              f"tpu_specs.active_cap={SMALL_ACTIVE_CAP}"], str(tmp_path))
    assert slam.overflow_events["active"] >= 1 and slam._defer_replays >= 1
    assert slam.map_cfg.active_cap > SMALL_ACTIVE_CAP
    assert slam.dropped_delta_events == 0 and slam._inflight is None
    assert len(slam.state.frame_telemetry) == N_FRAMES - 1
    np.testing.assert_allclose(poses, quiet[True][1], rtol=0, atol=1e-5)


def test_resume_from_deferred_checkpoint_is_bit_stable(quiet):
    """A checkpoint the deferred run wrote at frame CKPT_FREQ (its save
    drained the newer frame, so it holds the loop through frame
    CKPT_FREQ + 1) loaded into a fresh pipeline and run on: the final
    trajectory equals the uninterrupted run's bit for bit, and the device
    pose recurrence comes back as saved (the last tracked pose exactly)."""
    s_def, p_def, _, _ = quiet[True]
    ckpt = os.path.join(s_def.logger.dir, "ckpt", f"{CKPT_FREQ:05d}")
    data = np.load(os.path.join(ckpt, "state.npz"))
    assert np.isfinite(data["dev_last_pose6"]).all() and np.isfinite(data["dev_prev_pose6"]).all()
    np.testing.assert_array_equal(data["dev_last_pose6"], data["last_pose6"])
    b = NerfLoamSLAM_torch(s_def.cfg, s_def.dataset, device="cpu")
    load_checkpoint(ckpt, b)
    assert b._inflight is None and b.state.last_frame.index == CKPT_FREQ + 1
    np.testing.assert_array_equal(b._dev_last_pose6.numpy(), data["dev_last_pose6"])
    np.testing.assert_array_equal(b._dev_prev_pose6.numpy(), data["dev_prev_pose6"])
    np.testing.assert_array_equal(np.asarray(b.run()), p_def)
    assert b._inflight is None and b.dropped_delta_events == 0
