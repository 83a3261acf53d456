"""The port's copy of the numpy dataset code (nerfloam_tpu_torch/data)
against the JAX package's: the synthetic sequences of the two configs the
port runs give bit-identical scans, cosines and poses; the copied ground
segmentation, range filter and KITTI reader give exactly what the JAX
package's numpy functions give on a seeded cloud."""

import os

import numpy as np
import pytest

from nerfloam_tpu.data import get_dataset as j_get_dataset
from nerfloam_tpu.data import ground as jground
from nerfloam_tpu.data import kitti as jkitti
from nerfloam_tpu_torch.data import get_dataset as t_get_dataset
from nerfloam_tpu_torch.data import ground as tground
from nerfloam_tpu_torch.data import kitti as tkitti
from nerfloam_tpu_torch.utils.config import load_json_config

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.mark.parametrize("name", ["kitti_budget", "kitti_quality"])
def test_synthetic_dataset_bit_identical(name):
    cfg = load_json_config(os.path.join(ROOT, "nerfloam_tpu_torch", "configs", f"{name}.json"))
    jds, tds = j_get_dataset(cfg), t_get_dataset(cfg)
    assert len(jds) == len(tds) == 30
    np.testing.assert_array_equal(tds.gt_trajectory(), jds.gt_trajectory())
    np.testing.assert_array_equal(tds.get_init_pose(0), jds.get_init_pose(0))
    for i in (0, 1, 17, 29):  # in order: both draw from their own seeded noise stream
        ji, jp, jc, jpose = jds[i]
        ti, tp, tc, tpose = tds[i]
        assert ti == ji and tpose is None and jpose is None
        assert tp.dtype == jp.dtype and tc.dtype == jc.dtype
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tc, jc)
        assert len(tp) > 30000


def _cloud(seed=0, n=20000):
    """Ground ring, walls and a few low outliers, KITTI-like ranges."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(1.0, 60.0, n)
    a = rng.uniform(-np.pi, np.pi, n)
    g = np.stack([r * np.cos(a), r * np.sin(a), -1.73 + rng.normal(0, 0.03, n)], -1)
    w = np.stack([rng.uniform(5, 30, n // 3), np.full(n // 3, 8.0) + rng.normal(0, 0.02, n // 3),
                  rng.uniform(-1.7, 3.0, n // 3)], -1)
    low = np.stack([rng.uniform(-5, 5, 50), rng.uniform(-5, 5, 50), rng.uniform(-6, -3.5, 50)], -1)
    pts = np.concatenate([g, w, low]).astype(np.float32)
    return np.concatenate([pts, rng.uniform(0, 1, (len(pts), 1)).astype(np.float32)], 1)


def test_ground_segmentation_matches_jax():
    pts = _cloud()[:, :3]
    jg, jc = jground.segment_ground(pts)
    tg, tc = tground.segment_ground(pts)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tc, jc)
    assert 0.3 < float(np.mean(tg)) < 0.95 and float(tc.min()) < 0.999
    np.testing.assert_array_equal(tground.points_with_cos(pts)[1], jground.points_with_cos(pts)[1])


def test_range_filter_and_reader_match_jax(tmp_path):
    raw = _cloud(seed=1)
    (tmp_path / "velodyne").mkdir()
    raw.tofile(tmp_path / "velodyne" / "000000.bin")
    jds = jkitti.DataLoader(str(tmp_path), max_depth=40.0, min_depth=2.0)
    tds = tkitti.DataLoader(str(tmp_path), max_depth=40.0, min_depth=2.0)
    # the JAX package's numpy path (base.py: z cutoff, then filter_range)
    pts = raw[:, :3]
    ref = jds.filter_range(pts[pts[:, 2] > jds.z_min])
    np.testing.assert_array_equal(tds.filter_range(pts), jds.filter_range(pts))
    np.testing.assert_array_equal(tds.filter_scan(raw), ref)
    idx, p, c, pose = tds[0]
    assert idx == 0 and pose is None and len(tds) == 1
    np.testing.assert_array_equal(p, ref)
    np.testing.assert_array_equal(c, jground.segment_ground(ref)[1])
    assert len(ref) < len(raw)
