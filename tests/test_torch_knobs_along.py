"""ba_pose_project=along in a 10-frame synthetic_small run beside the JAX
package's, on the CPU (its own file beside tests/test_torch_knobs.py, whose
helpers it runs, so that the test runner's workers can take the two files'
runs side by side). Tolerances as tests/test_torch_pipeline.py's: both ATEs
under 0.30 m and within 0.10 m of each other (random streams differ:
threefry against Philox); the along column of the BA-delta telemetry
under 1e-5 m in both."""

from test_torch_knobs import _ates, _runs


def test_ba_pose_project_along_slice_matches_jax():
    """ba_pose_project=along: BA's translation update is kept off the
    tracked motion, so the telemetry's along column reads ~0 in both
    packages (a row for every tracked frame BA freed)."""
    gt, jp, tp, js, ts = _runs(["tpu_specs.ba_pose_project=along"])
    _ates(gt, jp, tp)
    rows_j, rows_t = js.state.ba_delta_telemetry, ts.state.ba_delta_telemetry
    assert len(rows_t) == len(rows_j) == 9
    assert [r[0] for r in rows_t] == [r[0] for r in rows_j]
    along_t = max(abs(r[1]) for r in rows_t)
    along_j = max(abs(r[1]) for r in rows_j)
    lat_t = max(abs(r[2]) for r in rows_t)
    assert along_t < 1e-5 and along_j < 1e-5, (along_t, along_j)
    assert lat_t > 100 * along_t  # the lateral column is not projected
