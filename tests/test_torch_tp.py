"""Port parity: the dp x tp layout (``parallel/sharding.py``'s tp half:
``make_mesh``, ``shard_decoder_params``, ``tp_decoder_apply`` and
``make_sharded_ba_iteration``) against the JAX package's on its CPU mesh.

One module-scoped fixture runs JAX's forms here (the root conftest gives
JAX 8 virtual CPU devices) on ``make_mesh(4)`` (dp = 2 x tp = 2) and on one
device, then spawns four gloo ranks on the CPU once
(``parallel.sharding.spawn`` of ``tests/_torch_tp_cases.run_cases``, which
imports no JAX) and hands them numpy inputs. The BA problem is
``__graft_entry__._build_tiny_problem(n_rays=256)`` with its packed table
filled from a seeded normal draw (a fresh map's zero table gives the pose
and layer 0's weights zero gradients). JAX draws the placement jitter from
the step's replicated key, the same (R_local, M) array on every dp shard;
the port is handed that array. Rank r is held to JAX's device r, the mesh
coordinates (r // tp, r % tp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _torch_tp_cases
from nerfloam_tpu_torch.map.voxel_map import MapConfig
from nerfloam_tpu_torch.models.decoder import decoder_apply
from nerfloam_tpu_torch.ops.raycast import RaycastConfig
from nerfloam_tpu_torch.parallel import sharding
from nerfloam_tpu_torch.utils.bridge import decoder_params_from_jax

WORLD = 4
N_STEPS = 2
LRS = [0.02, 0.005, 0.001]
DEC_SPEC = {"layers": [{"w": P(None, "tp"), "b": P("tp")}, {"w": P("tp", None), "b": P()}],
            "out": {"w": P(), "b": P()}}


def _by_device(x):
    """{device id: numpy} of a jax array's per-device buffers."""
    return {s.device.id: np.asarray(s.data) for s in x.addressable_shards}


def _dec_leaves(d):
    """JAX's decoder pytree as the port's leaf order (w..., b...)."""
    layers = list(d["layers"]) + [d["out"]]
    return [l["w"] for l in layers] + [l["b"] for l in layers]


def _jax_ba(mesh, tiny, n_steps):
    """JAX's make_sharded_ba_iteration on ``mesh``: per step the loss and
    every device's pose, packed table and decoder blocks; after step 1
    every device's Adam moments; and the jitter each step drew."""
    from nerfloam_tpu.parallel.sharding import make_sharded_ba_iteration, shard_decoder_params

    map_cfg, rc, state, dec, pose6, pts, cos, val = tiny
    step, init_opt = make_sharded_ba_iteration(mesh, map_cfg, rc, truncation=0.3,
                                               max_depth=rc.max_depth)
    put = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    decs = shard_decoder_params(dec, mesh)
    st = jax.tree.map(lambda x: put(x, P()), state)
    pose = put(pose6, P())
    opt = init_opt(st, decs, pose)
    lrs = jnp.asarray(LRS, jnp.float32)
    dp = mesh.shape["dp"]
    out, us = [], []
    for k in range(n_steps):
        key = jax.random.PRNGKey(k)
        us.append(np.asarray(jax.random.uniform(key, (pts.shape[0] // dp, rc.n_samples),
                                                minval=1e-4, maxval=1.0 - 1e-4)))
        packed, decs, pose, loss, opt = step(st, decs, pose, put(pts, P("dp", None)),
                                             put(cos, P("dp")), put(val, P("dp")), lrs, key, opt)
        st = st._replace(packed=packed)
        rec = {"loss": _by_device(loss), "pose": _by_device(pose), "packed": _by_device(packed),
               "dec": [_by_device(l) for l in _dec_leaves(decs)]}
        if k == 0:
            mu = opt.mu
            rec["mu"] = [_by_device(mu[0])] + [_by_device(l) for l in _dec_leaves(mu[1])] + [
                _by_device(mu[2])]
        out.append(rec)
    return out, np.stack(us)


def _jax_decoder(mesh, dec, x, compute_dtype):
    from nerfloam_tpu.parallel.sharding import shard_decoder_params, tp_decoder_apply

    f = jax.jit(jax.shard_map(
        lambda p, h: tp_decoder_apply(p, h, compute_dtype), mesh=mesh,
        in_specs=(DEC_SPEC, P("dp", None)), out_specs=P("dp", None), check_vma=False))
    return np.asarray(f(shard_decoder_params(dec, mesh), x))


@pytest.fixture(scope="module")
def tp_runs():
    import __graft_entry__ as g
    from nerfloam_tpu.models.decoder import decoder_apply as jdecoder_apply
    from nerfloam_tpu.models.decoder import init_decoder
    from nerfloam_tpu.parallel.sharding import make_mesh

    mesh = make_mesh(WORLD)
    one = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    # the decoder cases: the shipped decoder (16 -> 256 -> 256 -> 1)
    dec, meta = init_decoder(jax.random.key(0), depth=2, width=256, in_dim=16)
    x = jax.random.normal(jax.random.key(1), (64, 16), jnp.float32)
    jdec = {dt: _jax_decoder(mesh, dec, x, getattr(jnp, dt)) for dt in ("float32", "bfloat16")}
    jplain = np.asarray(jdecoder_apply(dec, meta, x))
    # the BA problem
    (map_cfg, rc, state, bdec, _, pose6, _, _, _, frame) = g._build_tiny_problem(n_rays=256)
    rng = np.random.default_rng(5)
    state = state._replace(packed=jnp.asarray(
        rng.normal(0.0, 0.05, np.asarray(state.packed).shape).astype(np.float32)))
    fpts, fcos, fval = frame
    ridx = np.linspace(0, int(np.asarray(fval).sum()) - 1, 256).astype(np.int32)
    pts, cos, val = (jnp.asarray(np.asarray(a)[ridx]) for a in (fpts, fcos, fval))
    tiny = (map_cfg, rc, state, bdec, pose6, pts, cos, val)
    jax_tp, u_tp = _jax_ba(mesh, tiny, N_STEPS)
    jax_one, u_one = _jax_ba(one, tiny, N_STEPS)
    jax.clear_caches()
    host = {
        "map_cfg": {k: getattr(map_cfg, k) for k in MapConfig._fields if hasattr(map_cfg, k)},
        "state": {k: np.asarray(v) for k, v in jax.device_get(state)._asdict().items()
                  if v is not None},
        "rc": {k: getattr(rc, k) for k in RaycastConfig._fields if hasattr(rc, k)},
        "dec": jax.device_get(bdec), "pose6": np.asarray(pose6), "lrs": LRS,
        "pts": np.asarray(pts), "cos": np.asarray(cos), "val": np.asarray(val),
        "u": {2: u_tp, 1: u_one},
    }
    inputs = {"decoder": {"dec": jax.device_get(dec), "x": np.asarray(x)}, "ba": host,
              "n_steps": N_STEPS}
    ranks = sharding.spawn(_torch_tp_cases.run_cases, WORLD, ["cpu"] * WORLD, "gloo", (inputs,))
    return {"mesh": mesh, "jax_dec": jdec, "jax_plain": jplain, "jax_tp": jax_tp,
            "jax_one": jax_one, "ranks": ranks, "dec": jax.device_get(dec), "x": np.asarray(x)}


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shape_matches_jax(n):
    from nerfloam_tpu.parallel.sharding import make_mesh

    m = make_mesh(n)
    assert sharding.mesh_shape(n) == (m.shape["dp"], m.shape["tp"])


def test_mesh_ranks_laid_out_as_jax(tp_runs):
    """Rank r sits at JAX's device r of ``devs.reshape(dp, tp)``."""
    devs = np.asarray([d.id for d in tp_runs["mesh"].devices.flat]).reshape(2, 2)
    for r, got in enumerate(tp_runs["ranks"]):
        i, j = np.argwhere(devs == r)[0]
        assert got["mesh"] == [2, 2, int(i), int(j)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tp_decoder_matches_jax_and_plain(tp_runs, dtype):
    """Every rank's tp_decoder_apply within 2e-5 of JAX's shard_map form
    (test_sharding.py's tolerance) and of one process's decoder_apply."""
    import torch

    dec = decoder_params_from_jax(tp_runs["dec"], device="cpu")
    x = torch.as_tensor(np.array(tp_runs["x"]))
    plain = decoder_apply(dec, x, getattr(torch, dtype)).numpy()
    for r in tp_runs["ranks"]:
        np.testing.assert_allclose(r["decoder"][dtype], tp_runs["jax_dec"][dtype], atol=2e-5)
        np.testing.assert_allclose(r["decoder"][dtype], plain, atol=2e-5)
    np.testing.assert_allclose(tp_runs["jax_dec"]["float32"], tp_runs["jax_plain"], atol=2e-5)


def _close_to_largest(got, ref, tol=1e-5, what=""):
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


@pytest.mark.parametrize("layout", ["tp", "one"])
def test_raw_gradients_match_jax(tp_runs, layout):
    """Step 1's raw gradients (Adam's first moment, 0.1 g) of the packed
    table, every decoder leaf and the pose within 1e-5 of each one's
    largest entry of JAX's on the same device, and the loss within 1e-5
    relative: the four ranks against JAX's dp = 2 x tp = 2 mesh, and one
    process against JAX's one device."""
    ref = tp_runs["jax_tp" if layout == "tp" else "jax_one"][0]
    ranks = (enumerate(r["ba"][0] for r in tp_runs["ranks"]) if layout == "tp"
             else [(0, tp_runs["ranks"][0]["ba_one"][0])])
    for r, got in ranks:
        assert len(got["mu"]) == len(ref["mu"])
        for i, (g_, jref) in enumerate(zip(got["mu"], ref["mu"])):
            assert np.abs(jref[r]).max() > 0, f"leaf {i} has a zero gradient"
            _close_to_largest(g_, jref[r], what=f"rank {r} leaf {i}")
        np.testing.assert_allclose(got["loss"], ref["loss"][r], rtol=1e-5)


def test_gradient_rule_is_jaxs(tp_runs):
    """What JAX's transpose rule does, on both sides: the split decoder
    leaves' gradients are tp = 2 times one device's, the replicated ones
    equal (within 1e-5 of the largest entry), and the packed table's and
    the pose's gradients differ between the tp ranks of a dp row."""
    for side, tp_, one in (("jax", tp_runs["jax_tp"][0]["mu"], tp_runs["jax_one"][0]["mu"]),
                           ("port", [{r: x["ba"][0]["mu"][i] for r, x in
                                      enumerate(tp_runs["ranks"])} for i in range(8)],
                            [{0: m} for m in tp_runs["ranks"][0]["ba_one"][0]["mu"]])):
        # leaves: 0 packed, 1-3 w0 w1 w_out, 4-6 b0 b1 b_out, 7 pose
        w0 = np.concatenate([tp_[1][0], tp_[1][1]], axis=1)
        b0 = np.concatenate([tp_[4][0], tp_[4][1]])
        w1 = np.concatenate([tp_[2][0], tp_[2][1]], axis=0)
        # dp = 2: every gradient is dp times the returned loss's (local
        # counts, then the pmean), so hold the tp = 2 mesh to twice one
        # device's only where the local counts cancel: the split leaves are
        # a further tp times the replicated ones' ratio
        ratio = float(np.abs(tp_[6][0]).max() / np.abs(one[6][0]).max())
        for leaf, full in ((w0, one[1][0]), (b0, one[4][0]), (w1, one[2][0])):
            assert float(np.abs(leaf).max()) > 1.5 * ratio * float(np.abs(full).max()) * 0.9, side
        for i in (3, 5, 6):
            np.testing.assert_array_equal(tp_[i][0], tp_[i][1], err_msg=f"{side} leaf {i}")
        for i in (0, 7):
            assert not np.array_equal(tp_[i][0], tp_[i][1]), f"{side} leaf {i}"
            np.testing.assert_array_equal(tp_[i][0], tp_[i][2], err_msg=f"{side} leaf {i}")


@pytest.mark.parametrize("layout", ["tp", "one"])
def test_two_steps_match_jax(tp_runs, layout):
    """After two steps, each rank against JAX's device under the aggregate
    tolerances of test_sharded_ba_step_matches_single_chip: loss rtol 1e-2,
    pose atol 1e-3, the packed table's mean difference under 5e-4 and
    under 1% of its entries over 1e-2."""
    ref = tp_runs["jax_tp" if layout == "tp" else "jax_one"][-1]
    ranks = (enumerate(r["ba"][-1] for r in tp_runs["ranks"]) if layout == "tp"
             else [(0, tp_runs["ranks"][0]["ba_one"][-1])])
    for r, got in ranks:
        np.testing.assert_allclose(got["loss"], ref["loss"][r], rtol=1e-2)
        np.testing.assert_allclose(got["pose"], ref["pose"][r], atol=1e-3)
        diff = np.abs(got["packed"] - ref["packed"][r])
        assert float(diff.mean()) < 5e-4, diff.mean()
        assert float((diff > 1e-2).mean()) < 0.01, (diff > 1e-2).mean()


def test_ranks_equal_where_jax_devices_are(tp_runs):
    """After every step, two ranks hold the same bits of the packed table,
    the pose and each decoder leaf exactly where JAX's two devices do: the
    dp replicas of a tp column always, the replicated decoder leaves on all
    four after step 1; the pose and table differ between the tp ranks of a
    row, and from step 2 on (the rays then leave from the tp ranks' own
    poses) the replicated leaves too."""
    ranks = tp_runs["ranks"]
    for k in range(N_STEPS):
        jref = tp_runs["jax_tp"][k]
        for r in range(WORLD):
            for q in range(WORLD):
                a, b = ranks[r]["ba"][k], ranks[q]["ba"][k]
                for name, x, y, jx, jy in (
                        [("packed", a["packed"], b["packed"], jref["packed"][r],
                          jref["packed"][q]),
                         ("pose", a["pose"], b["pose"], jref["pose"][r], jref["pose"][q])]
                        + [(f"leaf {i}", a["dec"][i], b["dec"][i], jref["dec"][i][r],
                            jref["dec"][i][q]) for i in (2, 4, 5)]):
                    assert np.array_equal(x, y) == np.array_equal(jx, jy), (k, r, q, name)
            np.testing.assert_array_equal(ranks[r]["ba"][k]["packed"],
                                          ranks[r % 2]["ba"][k]["packed"])
    first = tp_runs["jax_tp"][0]
    for i in (2, 4, 5):
        assert all(np.array_equal(first["dec"][i][r], first["dec"][i][0]) for r in range(WORLD))
