"""Port parity: the shipped configs, the CLIs and the JAX package's
test-only helpers.

- Every ``configs/**/*.yaml`` has a JSON twin under
  ``nerfloam_tpu_torch/configs/shipped/``: the port's ``load_json_config``
  of it equals JAX's ``load_config`` of the YAML (``base_config`` resolved
  into the dict, the key itself dropped) and so do their
  ``derive_static_shapes``; ``scripts/yaml_configs_to_json.py --check``
  finds no twin stale.
- ``utils.config.parse_cli`` (``demo/run_torch.py``'s leaf flags) against
  JAX's ``parse_cli`` on the same argvs over the YAML and its twin.
- ``demo/eval_torch.py`` (``traj``, ``mesh``) against ``demo/eval.py`` on
  the same files, importing neither jax, yaml nor the JAX package.
- ``ops/keys.py``'s codec bit-equal to JAX's on the inputs of
  tests/test_keys.py; ``ops/raycast.py``'s ``match_z_in_hits``,
  ``ray_intersect``, ``ray_sample`` and ``sample_along_rays`` against
  JAX's on the wall map of tests/test_cdf_sampler.py, fed JAX's jitter.
"""

import glob
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloam_tpu.ops import keys as jkeys
from nerfloam_tpu.ops import raycast as jrc
from nerfloam_tpu.utils.config import derive_static_shapes as j_shapes
from nerfloam_tpu.utils.config import load_config
from nerfloam_tpu.utils.config import parse_cli as j_parse_cli
from nerfloam_tpu_torch.ops import keys as tkeys
from nerfloam_tpu_torch.ops import raycast as trc
from nerfloam_tpu_torch.utils.bridge import hit_table_from_numpy, map_state_from_numpy
from nerfloam_tpu_torch.utils.config import derive_static_shapes, load_json_config, parse_cli
from tests.test_cdf_sampler import MAP_CFG, MAX_DEPTH, RC, build_wall_map, rays_along_x

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
YAMLS = sorted(os.path.relpath(p, os.path.join(ROOT, "configs"))
               for p in glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))
SHIPPED = os.path.join(ROOT, "nerfloam_tpu_torch", "configs", "shipped")


def _twin(rel):
    return os.path.join(SHIPPED, os.path.splitext(rel)[0] + ".json")


def _jax_dict(cfg):
    d = cfg.as_dict()
    d.pop("base_config", None)
    return d


@pytest.mark.parametrize("rel", YAMLS)
def test_shipped_twin_equals_jax_config(rel):
    """The twin's config and static shapes; a base config (kitti.yaml,
    maicity.yaml, ncd.yaml) names no data depth, and both packages' shapes
    raise the same KeyError on it."""
    ref = load_config(os.path.join(ROOT, "configs", rel))
    got = load_json_config(_twin(rel))
    assert got.as_dict() == _jax_dict(ref)
    try:
        want = j_shapes(ref)
    except KeyError as e:
        with pytest.raises(KeyError) as err:
            derive_static_shapes(got)
        assert err.value.args == e.args
        return
    assert derive_static_shapes(got) == want


def test_twins_are_current():
    """The script that writes the twins finds none stale (and one per
    YAML)."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "yaml_configs_to_json.py"),
                          "--check"], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(glob.glob(os.path.join(SHIPPED, "**", "*.json"), recursive=True)) == len(YAMLS)


ARGVS = [
    [],
    ["--exp_name", "x/y", "--tracker_specs.num_iterations", "10", "--debug"],
    ["--tpu_specs.defer_sync", "false", "--mapper_specs.voxel_size", "0.3",
     "--set", "tpu_specs.seed=5", "--set", "data_specs.use_gt=True"],
    ["--decoder_specs.skips", "[0]", "--tpu_specs.compute_dtype", "bfloat16",
     "--set", "tpu_specs.track_method=adam", "--resume", "/tmp/ckpt"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["none", "leaf", "bools_set", "list_resume"])
def test_leaf_flags_parse_as_jax(argv):
    rel = os.path.join("synthetic", "synthetic_small.yaml")
    jargs, jcfg = j_parse_cli([os.path.join(ROOT, "configs", rel)] + argv)
    args, cfg = parse_cli([_twin(rel)] + argv)
    assert cfg.as_dict() == _jax_dict(jcfg)
    assert (args.resume, args.debug, args.set) == (jargs.resume, jargs.debug, jargs.set)
    assert args.device == "cuda"


def _run_jax_eval(argv):
    sys.path.insert(0, os.path.join(ROOT, "demo"))
    try:
        import eval as jeval
    finally:
        sys.path.pop(0)
    saved, buf = sys.argv, io.StringIO()
    sys.argv = ["eval.py"] + argv
    try:
        with redirect_stdout(buf):
            jeval.main()
    finally:
        sys.argv = saved
    return json.loads(buf.getvalue())


def _run_port_eval(argv):
    """demo/eval_torch.py in a process of its own, which must import
    neither jax, yaml nor the JAX package."""
    code = ("import runpy, sys, json\n"
            f"sys.argv = ['eval_torch.py'] + {argv!r}\n"
            "runpy.run_path('demo/eval_torch.py', run_name='__main__')\n"
            "bad = [m for m in ('jax', 'yaml') if m in sys.modules]\n"
            "bad += [m for m in sys.modules if m == 'nerfloam_tpu' or "
            "m.startswith('nerfloam_tpu.')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout)


def test_eval_torch_matches_eval(tmp_path):
    from nerfloam_tpu_torch.utils.logger import write_ply

    rng = np.random.default_rng(0)
    gt = np.tile(np.eye(4), (12, 1, 1))
    gt[:, 0, 3] = np.arange(12) * 0.5
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.05, (12, 3))
    np.save(tmp_path / "est.npy", est)
    np.savetxt(tmp_path / "gt.txt", gt[:, :3, :].reshape(12, 12))
    traj = ["traj", "--est", str(tmp_path / "est.npy"), "--gt", str(tmp_path / "gt.txt")]
    assert _run_port_eval(traj) == _run_jax_eval(traj)
    g = np.stack(np.meshgrid(np.arange(6.0), np.arange(6.0)), -1).reshape(-1, 2)
    verts = np.concatenate([g, np.zeros((36, 1))], 1).astype(np.float32)
    faces = np.asarray([[i * 6 + j, i * 6 + j + 1, i * 6 + j + 6] for i in range(5)
                        for j in range(5)], np.int32)
    write_ply(str(tmp_path / "mesh.ply"), verts, faces)
    cloud = rng.uniform(0, 5, (2000, 3)).astype(np.float32)
    cloud[:, 2] = rng.normal(0, 0.03, 2000)
    np.save(tmp_path / "gt_cloud.npy", cloud)
    np.save(tmp_path / "obs.npy", cloud[:500])
    mesh = ["mesh", "--mesh", str(tmp_path / "mesh.ply"), "--gt-cloud",
            str(tmp_path / "gt_cloud.npy"), "--n-samples", "5000", "--crop-observed",
            str(tmp_path / "obs.npy"), "--clean-with", str(tmp_path / "obs.npy")]
    got, ref = _run_port_eval(mesh), _run_jax_eval(mesh)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)


# ---------------------------------------------------------------- keys


def _keys_cases():
    rng = np.random.default_rng(0)
    yield "roundtrip", rng.integers(-(1 << 20), (1 << 20) - 2, size=(1000, 3)).astype(np.int32)
    yield "small", np.random.default_rng(1).integers(-500, 500, size=(5000, 3)).astype(np.int32)
    yield "morton", np.random.default_rng(2).integers(-(1 << 20), (1 << 20) - 1,
                                                      size=(512, 3)).astype(np.int32)
    yield "dups", np.random.default_rng(3).integers(-4, 4, size=(2000, 3)).astype(np.int32)


@pytest.mark.parametrize("case", [c for c, _ in _keys_cases()])
def test_keys_bit_equal_to_jax(case):
    coords = dict(_keys_cases())[case]
    jh, jl = jkeys.pack(jnp.asarray(coords))
    th, tl = tkeys.pack(torch.as_tensor(coords))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tkeys.unpack(th, tl).numpy(), np.asarray(jkeys.unpack(jh, jl)))
    mh, ml = jkeys.morton_encode(jnp.asarray(coords))
    th2, tl2 = tkeys.morton_encode(torch.as_tensor(coords))
    np.testing.assert_array_equal(th2.numpy(), np.asarray(mh))
    np.testing.assert_array_equal(tl2.numpy(), np.asarray(ml))
    np.testing.assert_array_equal(tkeys.morton_decode(th2, tl2).numpy(),
                                  np.asarray(jkeys.morton_decode(mh, ml)))
    # the sort, with the invalid sentinel appended
    hi = np.append(np.asarray(jh), np.int32(jkeys.INVALID_HI))
    lo = np.append(np.asarray(jl), np.int32(jkeys.INVALID_LO))
    order = tkeys.lexsort_keys(torch.as_tensor(hi), torch.as_tensor(lo)).numpy()
    np.testing.assert_array_equal(order, np.asarray(jkeys.lexsort_keys(jnp.asarray(hi),
                                                                       jnp.asarray(lo))))
    assert order[-1] == len(hi) - 1
    assert (tkeys.INVALID_HI, tkeys.INVALID_LO) == (int(jkeys.INVALID_HI), int(jkeys.INVALID_LO))


# -------------------------------------------------------------- raycast


@pytest.fixture(scope="module")
def wall():
    m = build_wall_map()
    return m, map_state_from_numpy(jax.device_get(m), device="cpu")


def _t(x):
    return torch.as_tensor(np.array(x))


def test_match_z_in_hits_matches_jax(wall):
    m, tm = wall
    o, d, t_cap = rays_along_x(32)
    ht = jrc.build_hit_table(m, MAP_CFG, RC._replace(sampler="hits", max_hits=20), o, d, t_cap)
    z = jnp.asarray(np.linspace(0.3, MAX_DEPTH - 0.3, 24, dtype=np.float32)[None, :]).repeat(32, 0)
    onehot, aid, found = jrc.match_z_in_hits(ht, z)
    idx, taid, tfound = trc.match_z_in_hits(hit_table_from_numpy(jax.device_get(ht), "cpu"), _t(z))
    np.testing.assert_array_equal(taid.numpy(), np.asarray(aid))
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(found))
    f = np.asarray(found)
    assert f.any()
    np.testing.assert_array_equal(idx.numpy()[f], np.asarray(onehot).argmax(-1)[f])


def test_ray_intersect_and_sample_match_jax(wall):
    m, tm = wall
    o, d, _ = rays_along_x(16)
    ref = jrc.ray_intersect(m, MAP_CFG, RC, o, d, max_hits=20)
    got = trc.ray_intersect(tm, MAP_CFG, trc.RaycastConfig(**RC._asdict()), _t(o), _t(d), 20)
    for g_, r_ in zip(got, ref):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(r_))
    assert bool(np.asarray(ref[3]).all()) and (np.asarray(ref[0]) >= 0).sum() == 16 * 6
    key = jax.random.key(0)
    u = jax.random.uniform(key, (16, 64), minval=1e-4, maxval=1.0 - 1e-4)
    jz, jids, jval = jrc.ray_sample(*ref[:3], 64, key)
    tz, tids, tval = trc.ray_sample(*got[:3], 64, _t(u))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=0, atol=1e-5)
    # jitter off: the midpoints
    jz, _, _ = jrc.ray_sample(*ref[:3], 64, key, jitter=False)
    tz, _, _ = trc.ray_sample(*got[:3], 64)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=0, atol=1e-5)


def test_sample_along_rays_matches_jax(wall):
    m, tm = wall
    o, d, t_cap = rays_along_x(32)
    key = jax.random.key(2)
    u = jax.random.uniform(key, (32, RC.n_slots), minval=0.001, maxval=0.999)
    ref = jrc.sample_along_rays(m, MAP_CFG, RC, o, d, t_cap, key)
    got = trc.sample_along_rays(tm, MAP_CFG, trc.RaycastConfig(**RC._asdict()), _t(o), _t(d),
                                _t(t_cap), _t(u))
    for g_, r_ in zip(got, ref):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(r_))
    assert np.asarray(ref[2]).any()
    t_cap6 = jnp.full_like(t_cap, 6.0)
    ref = jrc.sample_along_rays(m, MAP_CFG, RC, o, d, t_cap6, key, jitter=False)
    got = trc.sample_along_rays(tm, MAP_CFG, trc.RaycastConfig(**RC._asdict()), _t(o), _t(d),
                                _t(t_cap6))
    for g_, r_ in zip(got, ref):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(r_))
