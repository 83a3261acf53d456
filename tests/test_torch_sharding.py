"""Port parity: ray data parallelism (``tpu_specs.dp``) over torch.distributed
against the JAX package's dp mesh on the CPU.

One module-scoped fixture runs JAX's dp=4 ``shard_map`` forms here (the
root conftest gives JAX 8 virtual CPU devices), then spawns four gloo ranks
on the CPU once (``parallel.sharding.spawn`` of
``tests/_torch_dp_cases.run_cases``, which imports no JAX) and hands them
numpy inputs. Random streams differ between the packages (threefry and
Philox), so both sides are fed the same numpy draws: JAX's traced loop body
draws one constant per kind, the port's ranks each draw the global arrays
and keep their block, so the port's global jitter is JAX's local one
repeated per rank (the GN tracker) or JAX's global one (BA). Held:

- (i) the gradient scale: ``test_sharded_grad_scale_matches_single_device``'s
  problem; the ranks' summed gradient of the sharded loss equals the
  single-process gradient (JAX's and the port's), rtol 1e-5;
- (ii) the GN tracker, grid and hits, and grid with the scan-to-scan term
  (the frame's own scan as the previous one, at its true pose), on
  ``_build_tiny_problem(n_rays=256)`` against JAX's ``_track_gn_core``
  under shard_map at dp=4: equal hit counts, the pose within 2e-4
  (tests/test_sharding.py's tolerance);
- (iii) the BA step, superset 2 and 0, and the exact-gradient step
  (``exact_embedding_grads``, superset 0), against JAX's
  ``make_sharded_ba_step`` at dp=4, under that test's tolerances;
- (iv) a dp=4 pipeline over 6 ``synthetic_small`` frames with the overrides
  of ``test_pipeline_dp_runs_and_tracks``, and over 4 with the Adam tracker
  (whole on every rank, BA sharded): ATE < 0.6 m;
- (v) every rank's outputs bit-equal to rank 0's, and only rank 0's
  logger writes files;
- the pipeline with dp > 1 and no process group raises naming ``run_dp``,
  and with a ray count dp does not divide raises as JAX's does.
"""

import os
from contextlib import ExitStack

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_dp_cases
from nerfloam_tpu.utils.config import load_config
from nerfloam_tpu_torch.core import tracking as ttr
from nerfloam_tpu_torch.data import get_dataset
from nerfloam_tpu_torch.map.voxel_map import MapConfig
from nerfloam_tpu_torch.ops.raycast import RaycastConfig
from nerfloam_tpu_torch.parallel import sharding
from nerfloam_tpu_torch.utils import evaluation as tev
from nerfloam_tpu_torch.utils.config import finalize

ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG_PATH = os.path.join(ROOT, "configs", "synthetic", "synthetic_small.yaml")
DP_OVERRIDES = ["data_specs.n_frames=6", "tpu_specs.bootstrap_steps=4",
                "tracker_specs.num_iterations=10", "mapper_specs.num_iterations=10",
                "tpu_specs.dp=4"]
DP = 4


class _Draws:
    """Seeded numpy draws by (kind, shape), the same array each time one is
    asked for (a traced loop body asks once per trace)."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.made = {}

    def get(self, kind, shape, lo=0.0, hi=1.0):
        key = (kind, tuple(int(s) for s in shape))
        if key not in self.made:
            r = self.rng
            self.made[key] = (r.gumbel(size=key[1]) if kind == "gumbel"
                              else r.uniform(lo, hi, size=key[1]) if kind == "uniform"
                              else r.integers(lo, hi, size=key[1])).astype(
                                  np.int64 if kind == "randint" else np.float32)
        return self.made[key]


def _fed_jax(stack, draws):
    """JAX's gumbel, uniform and randint return ``draws``' arrays."""
    mp = stack.enter_context(pytest.MonkeyPatch.context())
    mp.setattr(jax.random, "gumbel",
               lambda key, shape, dtype=jnp.float32: jnp.asarray(draws.get("gumbel", shape)))
    mp.setattr(jax.random, "uniform",
               lambda key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0: jnp.asarray(
                   draws.get("uniform", shape, float(minval), float(maxval))))
    mp.setattr(jax.random, "randint",
               lambda key, shape, minval, maxval, dtype=jnp.int32: jnp.asarray(
                   draws.get("randint", shape, int(minval), int(maxval)).astype(np.int32)))


def _grad_problem():
    from nerfloam_tpu.core.losses import sdf_losses

    R, M = 32, 8
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    gt = jax.random.uniform(k1, (R, 3), minval=1.0, maxval=3.0)
    d = jnp.linalg.norm(gt, axis=-1, keepdims=True)
    z = jnp.linspace(0.3, 1.1, M)[None, :] * d
    sdf = 0.1 * jax.random.normal(k2, (R, M))
    valid = jax.random.uniform(k3, (R, M)) > 0.1
    raymask, cos = jnp.ones((R,), bool), jnp.ones((R,))
    g_ref = jax.grad(lambda s: sdf_losses(z, s, valid, raymask, gt, cos, 0.3, 10.0, 1.0,
                                          100.0)[0])(sdf)
    p = dict(z=z, sdf=sdf, valid=valid, raymask=raymask, gt=gt, cos=cos)
    return {k: np.asarray(v) for k, v in p.items()}, np.asarray(g_ref)


def _tiny_problem():
    import __graft_entry__ as g

    (map_cfg, rc, state, dec, meta, pose6, _r, _c, _v, frame) = g._build_tiny_problem(n_rays=256)
    fpts, fcos, fval = frame
    init = pose6 + jnp.asarray([0.05, -0.04, 0.02, 0, 0, 0.01], jnp.float32)
    host = {
        "map_cfg": {k: getattr(map_cfg, k) for k in MapConfig._fields if hasattr(map_cfg, k)},
        "state": {k: np.asarray(v) for k, v in jax.device_get(state)._asdict().items()
                  if v is not None},
        "rc": {k: getattr(rc, k) for k in RaycastConfig._fields if hasattr(rc, k)},
        "dec": jax.device_get(dec), "pose6": np.asarray(pose6), "init": np.asarray(init),
        "pts": np.asarray(fpts), "cos": np.asarray(fcos), "val": np.asarray(fval),
    }
    return (map_cfg, rc, state, dec, meta, pose6, init, fpts, fcos, fval), host


def _jax_gn(tiny, sampler, mesh, s2s=None):
    """JAX's GN tracker under shard_map; ``s2s``: (Scan2ScanParams, its
    PrevScan), the scan-to-scan term on."""
    from nerfloam_tpu.core import tracking as jtr

    map_cfg, rc, state, dec, meta, _, init, fpts, fcos, fval = tiny
    rc_s = rc._replace(sampler=sampler)
    tp = jtr.TrackParams(n_rays=256, num_iterations=4, truncation=0.3, max_depth=rc.max_depth,
                         fs_weight=1.0, sdf_weight=1000.0, s2s=None if s2s is None else s2s[0])
    prev = None if s2s is None else s2s[1]

    def body(map_state, dec_, init6, pts, cos, val, lr_, k, prev_):
        return jtr._track_gn_core("dp", DP, map_state, map_cfg, rc_s, tp, dec_, meta, init6,
                                  pts, cos, val, lr_, k, prev_scan=prev_)

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P(), out_specs=P(), check_vma=False))
    return f(state, dec, init, fpts, fcos, fval, jnp.asarray(0.01, jnp.float32),
             jax.random.key(9), prev)


def _jax_ba(tiny, superset, mesh, exact=False):
    from nerfloam_tpu.core import ba as jba

    map_cfg, rc, state, dec, meta, pose6, _, fpts, fcos, fval = tiny
    bp = jba.BAParams(n_frames=1, n_rays=256, num_iterations=4, truncation=0.3,
                      max_depth=rc.max_depth, fs_weight=1.0, sdf_weight=1000.0,
                      ray_superset=superset, exact_embedding_grads=exact)
    step = jba.make_sharded_ba_step(mesh, map_cfg, rc, bp, meta)
    return step(state, dec, pose6[None], fpts[None], fcos[None], fval[None],
                jnp.ones((1,), bool), jnp.ones((1,), bool), jnp.asarray(True),
                jnp.asarray([0.02, 0.005, 0.001], jnp.float32), jax.random.key(3))


def _cfg_dict(extra):
    return finalize(load_config(CFG_PATH, DP_OVERRIDES + extra).as_dict())._d


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    grad, g_ref = _grad_problem()
    tiny, host = _tiny_problem()
    mesh = Mesh(np.asarray(jax.devices()[:DP]), ("dp",))
    jax_out, inputs = {}, {"grad": grad, "tiny": host}
    P_pts = host["pts"].shape[0]
    for sampler in ("grid", "hits"):
        draws = _Draws(20 + len(sampler))
        with ExitStack() as stack:
            _fed_jax(stack, draws)
            jax_out[f"gn_{sampler}"] = jax.device_get(_jax_gn(tiny, sampler, mesh))
        # JAX's ranks each draw the local jitter (64, M) from one key: the
        # port's global draw is that block once per rank
        (u_loc,) = [v for (k, s), v in draws.made.items() if k == "uniform"]
        inputs[f"gn_{sampler}"] = {"gumbel": draws.get("gumbel", (P_pts,)),
                                   "uniform": np.tile(u_loc, (DP, 1))}
    # the scan-to-scan term: the frame's own scan as the previous one, at its true pose
    from nerfloam_tpu.core import scan2scan as js2s

    sp = js2s.Scan2ScanParams(weight=10.0, n_elev=16, n_az=128, gate_dist=1.0, huber=0.2,
                              min_depth=1.0, max_depth=12.0)
    jprev = js2s.build_prev_scan(sp, tiny[7], tiny[9], tiny[5])
    draws = _Draws(40)
    with ExitStack() as stack:
        _fed_jax(stack, draws)
        jax_out["gn_s2s"] = jax.device_get(_jax_gn(tiny, "grid", mesh, (sp, jprev)))
    (u_loc,) = [v for (k, s), v in draws.made.items() if k == "uniform"]
    inputs["gn_s2s"] = {"gumbel": draws.get("gumbel", (P_pts,)),
                        "uniform": np.tile(u_loc, (DP, 1))}
    inputs["s2s"] = {"sp": sp._asdict(),
                     "prev": {k: np.asarray(v) for k, v in jprev._asdict().items()}}
    for label, superset, exact in ((2, 2, False), (0, 0, False), ("exact", 0, True)):
        draws = _Draws(30 + superset + 5 * exact)
        with ExitStack() as stack:
            _fed_jax(stack, draws)
            jax_out[f"ba_{label}"] = jax.device_get(_jax_ba(tiny, superset, mesh, exact))
        made = {k: v for (k, _), v in draws.made.items()}
        inputs[f"ba_{label}"] = {"gumbel": made["gumbel"], "uniform": made["uniform"],
                                 "randint": made.get("randint")}
    jax.clear_caches()  # no traced constant of the fed draws outlives the fixture
    inputs["pipeline_cfg"] = _cfg_dict([])
    inputs["adam_cfg"] = _cfg_dict(["tpu_specs.track_method=adam", "data_specs.n_frames=4"])
    inputs["raises_cfg"] = _cfg_dict(["tracker_specs.N_rays=1022"])
    inputs["log_dir"] = str(tmp_path_factory.mktemp("dp_logs"))
    ranks = sharding.spawn(_torch_dp_cases.run_cases, DP, ["cpu"] * DP, "gloo", (inputs,))
    return {"g_ref": g_ref, "jax": jax_out, "ranks": ranks, "log_dir": inputs["log_dir"]}


def test_gradient_scale_matches_single_process(dp_runs):
    g = dp_runs["ranks"][0]["grad"]
    np.testing.assert_allclose(g["dp"], dp_runs["g_ref"], rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(g["dp"], g["one"], rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("sampler", ["grid", "hits", "s2s"])
def test_gn_tracker_matches_jax_dp_mesh(dp_runs, sampler):
    """The GN tracker under dp=4 against JAX's shard_map; "s2s": the grid
    sampler with the scan-to-scan term, K11b's system in the all-reduce."""
    port, ref = dp_runs["ranks"][0][f"gn_{sampler}"], dp_runs["jax"][f"gn_{sampler}"]
    assert port["hits"] == int(ref.hit_count) > 0
    np.testing.assert_allclose(port["pose"], np.asarray(ref.pose), atol=2e-4)


def test_s2s_term_moves_the_dp_tracker(dp_runs):
    """The scan-to-scan case is not the plain grid case: its term changes
    the loss and the pose, on both sides."""
    port, ref = dp_runs["ranks"][0], dp_runs["jax"]
    assert port["gn_s2s"]["loss"] != port["gn_grid"]["loss"]
    assert float(ref["gn_s2s"].loss) != float(ref["gn_grid"].loss)
    assert not np.array_equal(port["gn_s2s"]["pose"], port["gn_grid"]["pose"])


@pytest.mark.parametrize("superset", [2, 0, "exact"])
def test_ba_step_matches_jax_dp_mesh(dp_runs, superset):
    port, ref = dp_runs["ranks"][0][f"ba_{superset}"], dp_runs["jax"][f"ba_{superset}"]
    np.testing.assert_allclose(port["loss"], np.asarray(ref.loss), rtol=1e-2)
    np.testing.assert_allclose(port["poses"], np.asarray(ref.poses), atol=1e-3)
    diff = np.abs(port["embeddings"] - np.asarray(ref.embeddings, np.float32))
    assert float(diff.mean()) < 5e-4, diff.mean()
    assert float((diff > 1e-2).mean()) < 0.01, (diff > 1e-2).mean()
    assert abs(port["touched"] - int(ref.touched_count)) <= 2


@pytest.mark.parametrize("run", ["pipeline", "pipeline_adam"])
def test_dp_pipeline_tracks(dp_runs, run):
    """The dp=4 pipeline with the GN tracker ("pipeline", 6 frames) and with
    the Adam tracker ("pipeline_adam", 4 frames: the tracker whole on every
    rank, BA sharded)."""
    cfg = finalize(load_config(CFG_PATH, DP_OVERRIDES).as_dict())
    gt = get_dataset(cfg).gt_trajectory()
    poses = dp_runs["ranks"][0][run]["poses"]
    n = 6 if run == "pipeline" else 4
    assert poses.shape == (n, 4, 4)
    assert tev.ate_rmse(poses, gt[:n], align=False) < 0.6


def test_only_rank0_writes_outputs(dp_runs):
    """Every rank was given a logger; rank 0's wrote the run's pose files
    and meshes, and no other rank's wrote a file."""
    root = dp_runs["log_dir"]
    files = {r: [os.path.relpath(os.path.join(d, f), os.path.join(root, f"rank{r}"))
                 for d, _, fs in os.walk(os.path.join(root, f"rank{r}")) for f in fs]
             for r in range(DP)}
    assert all(not files[r] for r in range(1, DP)), files
    poses = [f for f in files[0] if f.endswith("frame_poses.npy")]
    assert len(poses) == 1 and any(f.endswith("final_mesh.ply") for f in files[0]), files[0]
    np.testing.assert_array_equal(np.load(os.path.join(root, "rank0", poses[0])),
                                  dp_runs["ranks"][0]["pipeline"]["poses"])


def test_ranks_bit_equal(dp_runs):
    ranks = dp_runs["ranks"]

    def flat(x, at=""):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from flat(v, f"{at}/{k}")
        else:
            yield at, x

    ref = dict(flat(ranks[0]))
    for r in ranks[1:]:
        got = dict(flat(r))
        assert got.keys() == ref.keys()
        for k, v in ref.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


def test_indivisible_ray_count_raises_as_jax(dp_runs):
    msg = dp_runs["ranks"][0]["raises"]
    assert msg == "tracker N_rays 1022 not divisible by dp 4", msg


def test_gn_sums_combine_to_the_one_launch_system():
    """K3's dp form's plain twin: the 58 per-class sums, combined, give the
    one-launch twin's H, b and loss."""
    rng = np.random.default_rng(0)
    N, M = 64, 12
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    xyz, g = t(rng.normal(size=(N, M, 3)) * 5), t(rng.normal(size=(N, M, 3)))
    z = t(rng.uniform(0.5, 20, (N, M)))
    sdf = t(rng.normal(size=(N, M)) * 0.3)
    vmask = torch.as_tensor(rng.uniform(size=(N, M)) > 0.2)
    pcos, d_meas = t(rng.uniform(0.5, 1.0, N)), t(rng.uniform(1, 20, N))
    depth_ok = torch.as_tensor(rng.uniform(size=N) > 0.1)
    bias = t(rng.normal(size=N) * 0.02)
    tp = ttr.TrackParams(n_rays=N, num_iterations=1, truncation=0.3, max_depth=40.0,
                         fs_weight=1.0, sdf_weight=1000.0)
    args = (xyz, t([0.1, -0.2, 0.3]), z, sdf, g, vmask, pcos, d_meas, depth_ok, tp, bias)
    H, b, loss = ttr.gn_system_plain(*args)
    sums = ttr.gn_sums_plain(*args)
    assert sums.shape == (ttr.GN_SUMS,)
    H2, b2, loss2 = ttr.gn_combine(sums, tp)
    for got, ref in ((H2, H), (b2, b), (loss2, loss)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(ref.abs().max()))
