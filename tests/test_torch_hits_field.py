"""K2's d packed order and K1 / K2's wrapper checks, on the CPU.

``render.dpacked_in_row_order_plain`` is K2's bit-exact oracle on the
card: d packed with each row's contributions w_corner * d feats added in
ascending sample index, from 0. Here it is held bit for bit (the f32
words compared) against a numpy float32 loop that adds the samples one at
a time in that order, rounding the weights in the kernel's operation
order; and, within 1e-5 of the largest entry (float32, another summation
order), against the plain twin ``hits_field_bwd_plain`` and against
jax.value_and_grad over the packed table of the JAX package's trilinear
interpolation, on tests/test_torch_render.py's map and rays. The K1 and
K2 wrappers take their inputs as the kernels read them: a tensor of
another dtype, layout or shape raises ValueError, on the CPU too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloam_tpu.ops.interp import interp_corner_features as j_interp
from nerfloam_tpu_torch.core import render as trender
from nerfloam_tpu_torch.ops import raycast as trc
from nerfloam_tpu_torch.ops import se3 as tse3
from nerfloam_tpu_torch.utils.bridge import hit_table_from_numpy
from tests.test_render_track import MAP_CFG, scene  # noqa: F401
from tests.test_torch_render import setup  # noqa: F401

torch.set_num_threads(2)
VS = 0.5


def _random_samples(seed, R=40, M=12, A=64, long_row=None):
    """Samples in random cells with random rows (the arithmetic needs no
    map); ``long_row`` funnels 300 valid samples into row 3."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-3.0, 3.0, (R, M, 3)).astype(np.float32)
    aid = rng.integers(0, A, (R, M)).astype(np.int32)
    valid = rng.uniform(size=(R, M)) > 0.3
    if long_row:
        flat = aid.reshape(-1)
        pick = rng.choice(flat.size, 300, replace=False)
        flat[pick] = 3
        valid.reshape(-1)[pick] = True
    dfeats = rng.normal(size=(R, M, 16)).astype(np.float32)
    return xyz, aid, valid, dfeats, A


def _numpy_row_order(xyz, aid, valid, dfeats, A):
    """Each valid sample in ascending index: its weights in K2's operation
    order, then one f32 multiply and one f32 add per entry of its row."""
    vs = np.float32(VS)
    half, one = np.float32(0.5), np.float32(1.0)
    out = np.zeros((A, 8, 16), np.float32)
    x, a, v, df = xyz.reshape(-1, 3), aid.reshape(-1), valid.reshape(-1), dfeats.reshape(-1, 16)
    for i in range(len(v)):
        if not v[i]:
            continue
        f = []
        for ax in range(3):
            center = (np.floor(x[i, ax] / vs) + half) * vs
            p = (x[i, ax] - center) / vs + half
            f.append((one - p, p))
        for j in range(8):
            w = (f[0][(j >> 2) & 1] * f[1][(j >> 1) & 1]) * f[2][j & 1]
            out[a[i], j] = out[a[i], j] + w * df[i]
    return out.reshape(A, 128)


@pytest.mark.parametrize("seed,long_row", [(0, False), (1, True)])
def test_dpacked_in_row_order_matches_numpy_loop(seed, long_row):
    xyz, aid, valid, dfeats, A = _random_samples(seed, long_row=long_row)
    ref = _numpy_row_order(xyz, aid, valid, dfeats, A)
    got = trender.dpacked_in_row_order_plain(*map(torch.as_tensor, (dfeats, xyz, aid, valid)), A,
                                             VS)
    assert got.dtype == torch.float32 and got.shape == (A, 128)
    np.testing.assert_array_equal(got.numpy().view(np.int32), ref.view(np.int32))
    assert (ref != 0).any(-1).sum() > A // 2
    # the order matters: a row added in another order rounds differently
    if long_row:
        assert int((aid[valid] == 3).sum()) >= 300


def test_dpacked_in_row_order_without_valid_samples():
    xyz, aid, valid, dfeats, A = _random_samples(2)
    got = trender.dpacked_in_row_order_plain(
        torch.as_tensor(dfeats), torch.as_tensor(xyz), torch.as_tensor(aid),
        torch.zeros(valid.shape, dtype=torch.bool), A, VS)
    assert torch.equal(got, torch.zeros((A, 128)))


def test_dpacked_in_row_order_matches_twin_and_jax(setup):  # noqa: F811
    s = setup
    ht = hit_table_from_numpy(jax.device_get(s["ht"]), device="cpu")
    dirs = torch.as_tensor(np.array(s["dirs"]))
    pose = torch.as_tensor(np.array(s["pose"]))
    d = tse3.rotate_dirs(pose, dirs)
    o = tse3.pose_translation(pose).expand_as(d)
    packed = torch.as_tensor(np.array(s["m"].packed))
    u = torch.as_tensor(s["u"])
    _, valid, aid, xyz, _ = trender.hits_field_fwd(ht, u, o, d, packed, MAP_CFG.voxel_size)
    assert 0.3 < float(valid.float().mean()) < 1.0
    rng = np.random.default_rng(5)
    dfeats = rng.normal(size=tuple(valid.shape) + (16,)).astype(np.float32)
    oracle = trender.dpacked_in_row_order_plain(torch.as_tensor(dfeats), xyz, aid, valid,
                                                packed.shape[0], MAP_CFG.voxel_size)
    _, twin = trender.hits_field_bwd_plain(torch.as_tensor(dfeats), xyz, aid, valid, packed,
                                           MAP_CFG.voxel_size, True)

    x, a, v = (t.numpy() for t in (xyz, aid, valid))
    vs = MAP_CFG.voxel_size

    def dot(pk):
        rows = pk[np.clip(a, 0, None)].reshape(a.shape + (8, 16))
        center = (jnp.floor(x / vs) + 0.5) * vs
        feats = jnp.where(v[..., None], j_interp(x, center, rows, vs), 0.0)
        return jnp.sum(feats * dfeats)

    _, jgrad = jax.value_and_grad(dot)(jnp.asarray(s["m"].packed))
    jgrad = np.asarray(jgrad)
    scale = float(np.abs(jgrad).max())
    assert scale > 0
    for name, got in (("oracle", oracle), ("twin", twin)):
        err = float(np.abs(got.numpy() - jgrad).max())
        assert err <= 1e-5 * scale, (name, err, scale)
    # the same rows touched, and nothing else
    np.testing.assert_array_equal((oracle != 0).any(-1).numpy(), (jgrad != 0).any(-1))


def _k1_inputs():
    from tests.test_torch_kernels import T_CFG, T_RC, _case
    ms, o, d, tc = _case("cpu", R=16)
    ht = trc.build_hit_table(ms, T_CFG, T_RC, o, d, tc)
    u = trc.uniform_jitter((16, 8), torch.Generator().manual_seed(0), "cpu")
    return ht, u, o, d, ms.packed


def test_hits_field_wrappers_reject_what_they_would_convert():
    ht, u, o, d, packed = _k1_inputs()
    z, valid, aid, xyz, feats = trender.hits_field_fwd(ht, u, o[:1].expand_as(d), d, packed, VS)
    ok = dict(ht=ht, u=u, rays_o=o, rays_d=d, packed=packed)
    for key, value, match in (
            ("u", u.double(), "u must be a contiguous"),
            ("rays_d", d.t().contiguous().t(), "rays_d must be a contiguous"),
            ("packed", packed.half(), "packed must be a contiguous"),
            ("ht", ht._replace(aid=ht.aid.long()), "aid must be a contiguous"),
            ("ht", ht._replace(cdf=ht.cdf.double()), "cdf must be"),
            ("rays_o", o.repeat(1, 2)[:, :3], "rays_o must be"),
            ("u", u[:8].contiguous(), r"u has shape"),
            # one ray's tables and samples past a block's shared memory
            ("u", torch.zeros((16, 9000)), "shared memory")):
        with pytest.raises(ValueError, match=match):
            trender.hits_field_fwd(**{**ok, key: value}, voxel_size=VS)
    dfeats = torch.randn(feats.shape)
    good = (dfeats, xyz, aid, valid, packed)
    for i, value, match in ((0, dfeats.transpose(0, 1).contiguous().transpose(0, 1),
                             "dfeats must be a contiguous"),
                            (1, xyz.double(), "xyz must be a contiguous"),
                            (2, aid.long(), "aid must be a contiguous"),
                            (3, valid.to(torch.uint8), "valid must be a contiguous"),
                            (4, packed[:, :64], "packed")):
        args = list(good)
        args[i] = value
        with pytest.raises(ValueError, match=match):
            trender.hits_field_bwd(*args, VS)
    # the table's three float columns may be views of one wider table (BA's
    # packed hit table), with one row stride
    wide = trc.unpack_hit_table(trc.pack_hit_table(ht))
    assert wide.cdf.stride(0) == 7 * ht.cdf.shape[1]
    ref = trender.hits_field_fwd(ht, u, o, d, packed, VS)
    got = trender.hits_field_fwd(wide, u, o, d, packed, VS)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
