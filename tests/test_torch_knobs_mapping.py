"""The mapper-side knobs of the port in 10-frame synthetic_small runs
beside the JAX package's, on the CPU: remove_back (the mapper's copy of a
frame drops far points behind the motion) and GT-pose mapping-only frames
(data_specs.use_gt). Tolerances as tests/test_torch_pipeline.py's: both
ATEs under 0.30 m and within 0.10 m of each other (random streams differ:
threefry against Philox); the GT trajectory to 1e-6 m."""

import json

import numpy as np

from test_torch_knobs import _ates, _runs


def test_remove_back_slice_matches_jax():
    """remove_back: the mapper's copy drops far points behind the motion
    (the same share in both packages); BA and the insert take its mask."""
    dropped = {}

    def hook(slam):
        key = type(slam).__name__
        dropped[key] = [0, 0]
        mapper_copy = slam._mapper_copy

        def counted(frame):
            out = mapper_copy(frame)
            back = out.without_back_points(slam.key_distance)
            dropped[key][0] += int(out.valid.sum() - back.valid.sum())
            dropped[key][1] += int(out.valid.sum())
            return out

        slam._mapper_copy = counted

    gt, jp, tp, js, ts = _runs(["mapper_specs.remove_back=true"], hook)
    _ates(gt, jp, tp)
    assert dropped["NerfLoamSLAM_torch"] == dropped["NerfLoamSLAM"]
    assert dropped["NerfLoamSLAM_torch"][0] > 0
    assert ts.remove_back and ts.dropped_delta_events == 0


def test_mapping_gt_slice_matches_jax():
    """data_specs.use_gt=true: every frame after the first is mapped at its
    ground-truth pose, no tracker: the tracking trajectory is the GT
    poses, BA refines the mapper's copy, one host read a frame."""
    gt, jp, tp, js, ts = _runs(["data_specs.use_gt=true"])
    ate_j, ate_t = _ates(gt, jp, tp)
    assert ate_t < 0.05 and ate_j < 0.05, (ate_t, ate_j)
    traj = np.asarray(ts.get_raw_trajectory())
    np.testing.assert_allclose(traj, np.asarray(js.get_raw_trajectory()), atol=1e-6)
    np.testing.assert_allclose(traj[:, :3, 3], gt[:, :3, 3], atol=1e-5)
    assert ts.state.frame_telemetry == [] and ts.state.ba_delta_telemetry == []
    assert ts.state.frames_processed == 10 and ts.dropped_delta_events == 0
    assert [f.index for f in ts.state.keyframes] == [f.index for f in js.state.keyframes]
    assert ts.host_syncs <= 9 + 1 + 6 + 16
    assert json.dumps(ts.overflow_events) == json.dumps(
        {k: int(v) for k, v in js.overflow_events.items()})
