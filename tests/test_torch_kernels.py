"""The port's CUDA kernels (K4 hit table, K1 hits field, K2 its backward,
K8 active field, K3 GN normal equations, K7 voxel insert, K6 recenter +
active set, K5 reconcile + repack, K9a occupancy march, K9b CDF
placement, K10a mesh lattice, K10b marching tetrahedra, K11a range image,
K11b point-to-plane system) against their plain torch twins, at small shapes. On a machine
without CUDA these tests skip (the `cuda` fixture decides, at run time);
run them on the card with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py`
(the file imports neither jax nor the repo's conftest, which imports jax:
the card's machine has no jax). The CPU-only checks at the end run
everywhere.

Tolerances as in chip_smoke.py: integers, depths and positions exact (the
kernels round exactly like the plain ops: no FMA contraction, IEEE
division); features 1e-6; d xyz 1e-5 relative; d packed 1e-5 of its
largest entry (another summation order than the twin's) and bit-identical
between two calls (each row adds its samples in ascending index); K8 integers and
positions exact, features 1e-6; K3 H, b and loss 1e-4 relative (another
summation order) and bit-stable from run to run; K7 every table equal
(both elect the smallest slot); K6 every table equal; K5 every table
equal to the twin run on the CPU (f32 and bf16: both add each corner's
deltas in ascending order, rounding after every add) and bit-identical
between two calls; K9a cdf and n_occ equal, K9b aid, valid and ray_mask
equal and z within one f32 ulp; the grid render's gradients on the card
1e-5 of the CPU's largest entry (another summation order); K10a features and
positions equal, K10b triangles and mask equal (one rounded operation at a
time on both sides); K11a every output equal and bit-identical between two
calls (per-pixel sums in ascending point index); K11b H, b and loss 1e-5
relative (another summation order) and bit-stable from run to run."""

import os

import numpy as np
import pytest
import torch

from nerfloam_tpu_torch import kernels
from nerfloam_tpu_torch.core import render as trender
from nerfloam_tpu_torch.core import scan2scan as ts2s
from nerfloam_tpu_torch.core import tracking as ttr
from nerfloam_tpu_torch.map import mesher as tmesher
from nerfloam_tpu_torch.map import voxel_map as vm
from nerfloam_tpu_torch.ops import marching as tmarch
from nerfloam_tpu_torch.ops import raycast as trc

torch.set_num_threads(2)
VS = 0.5
T_CFG = vm.MapConfig(capacity=1 << 14, grid_dim=(64, 64, 32), voxel_size=VS)
T_RC = trc.RaycastConfig(step_world=0.25 * VS, n_slots=97, n_samples=48, voxel_size=VS,
                         max_depth=12.0, sampler="hits", max_hits=20)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _case(device, R=96, seed=0):
    """Two walls of surface voxels (tests/test_cdf_sampler.py build_wall_map)
    with random embeddings, and oblique rays through them."""
    xs = []
    for xlo, xhi in ((4.0, 5.0), (8.0, 10.0)):
        for x in np.arange(xlo, xhi, VS):
            yy, zz = np.meshgrid(np.arange(-2, 2, VS), np.arange(-2, 2, VS))
            xs.append(np.stack([np.full(yy.size, x + 0.25), yy.ravel() + 0.25,
                                zz.ravel() + 0.25], -1))
    pts = torch.as_tensor(np.concatenate(xs), dtype=torch.float32)
    ms = vm.recenter(vm.create(T_CFG, "cpu"), T_CFG, torch.zeros(3))
    ms = vm.insert_points(ms, T_CFG, pts, torch.ones(len(pts), dtype=torch.bool))
    g = torch.Generator().manual_seed(seed)
    emb = torch.randn(ms.embeddings.shape, generator=g) * 0.3
    ms = vm.refresh_active(ms._replace(embeddings=emb), T_CFG)
    rng = np.random.default_rng(seed)
    o = np.zeros((R, 3), np.float32)
    o[:, 1:] = rng.uniform(-1.5, 1.5, size=(R, 2))
    d = np.stack([np.ones(R), rng.uniform(-0.2, 0.2, R), rng.uniform(-0.2, 0.2, R)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_cap = rng.uniform(6.0, 12.0, R).astype(np.float32)
    ms = type(ms)(*[x.to(device) for x in ms])
    return ms, *(torch.as_tensor(x, device=device) for x in (o, d, t_cap))


def test_hit_table_kernel_matches_plain(cuda):
    ms, o, d, tc = _case(cuda)
    n0 = trc.hit_table_launches
    ker = trc.build_hit_table(ms, T_CFG, T_RC, o, d, tc)
    ref = trc.build_hit_table_plain(ms, T_CFG, T_RC, o, d, tc)
    torch.cuda.synchronize()
    assert trc.hit_table_launches == n0 + 1
    for name in ("aid", "cell", "ray_mask", "t_near", "seg"):
        assert torch.equal(getattr(ker, name), getattr(ref, name)), name
    torch.testing.assert_close(ker.cdf, ref.cdf, rtol=1e-5, atol=0)
    assert bool(ker.ray_mask.any())


@pytest.mark.parametrize("M", [24, 48])
def test_hits_field_kernels_match_plain(cuda, M):
    ms, o, d, tc = _case(cuda, seed=M)
    ht = trc.build_hit_table_plain(ms, T_CFG, T_RC, o, d, tc)
    g = torch.Generator(device=cuda).manual_seed(M)
    u = trc.uniform_jitter((o.shape[0], M), g, cuda)
    o2 = (o + 0.02).contiguous()
    ker = trender.hits_field_fwd(ht, u, o2, d, ms.packed, T_CFG.voxel_size)
    ref = trender.hits_field_fwd_plain(ht, u, o2, d, ms.packed, T_CFG.voxel_size)
    for i, name in enumerate(("z", "valid", "aid", "xyz")):
        assert torch.equal(ker[i], ref[i]), name
    torch.testing.assert_close(ker[4], ref[4], rtol=0, atol=1e-6)
    _, valid, aid, xyz, _ = ref
    dfeats = torch.randn((o.shape[0], M, 16), generator=g, device=cuda)
    kx, kp = trender.hits_field_bwd(dfeats, xyz, aid, valid, ms.packed, T_CFG.voxel_size)
    rx, rp = trender.hits_field_bwd_plain(dfeats, xyz, aid, valid, ms.packed, T_CFG.voxel_size,
                                          True)
    assert float((kx - rx).abs().max()) <= 1e-5 * float(rx.abs().max())
    assert float((kp - rp).abs().max()) <= 1e-5 * float(rp.abs().max())
    kx2, kp2 = trender.hits_field_bwd(dfeats, xyz, aid, valid, ms.packed, T_CFG.voxel_size)
    assert torch.equal(kx, kx2) and torch.equal(kp, kp2)      # no atomics: the same every run
    untouched = torch.ones(len(kp), dtype=torch.bool, device=cuda)
    untouched[aid[valid].long()] = False
    assert float(kp[untouched].abs().max()) == 0.0 and bool(untouched.any())
    gx, none = trender.hits_field_bwd(dfeats, xyz, aid, valid, ms.packed, T_CFG.voxel_size,
                                      want_dpacked=False)
    assert none is None and torch.equal(gx, kx)


def test_hits_field_autograd_on_card_matches_cpu(cuda):
    ms, o, d, tc = _case(cuda, seed=3)
    ht = trc.build_hit_table(ms, T_CFG, T_RC, o, d, tc)
    u = trc.uniform_jitter((o.shape[0], 24), torch.Generator(device=cuda).manual_seed(0), cuda)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        packed = ms.packed.to(dev).clone().requires_grad_(True)
        oo = o.to(dev).clone().requires_grad_(True)
        dd = d.to(dev).clone().requires_grad_(True)
        h = trc.HitTable(*[x.to(dev) for x in ht])
        feats, *_ = trender.field_columns(packed, oo, dd, h, u.to(dev), T_CFG.voxel_size)
        (feats * torch.linspace(-1, 1, 16, device=dev)).sum().backward()
        grads[dev.type] = [x.grad.cpu() for x in (packed, oo, dd)]
    for k, c in zip(grads["cuda"], grads["cpu"]):
        assert float((k - c).abs().max()) <= 1e-5 * float(c.abs().max())


def test_active_field_kernel_matches_plain(cuda):
    ms, o, d, tc = _case(cuda, seed=5)
    g = torch.Generator(device=cuda).manual_seed(5)
    R, K = o.shape[0], 9
    z = torch.rand((R, K), generator=g, device=cuda) * 11.0 - 0.5
    rv = torch.rand((R,), generator=g, device=cuda) > 0.1
    n0 = trender.active_field_fwd_launches
    ker = trender.active_field_fwd(ms, T_CFG, ms.packed, o, d, z, rv)
    ref = trender.active_field_fwd_plain(ms, T_CFG, ms.packed, o, d, z, rv)
    torch.cuda.synchronize()
    assert trender.active_field_fwd_launches == n0 + 1
    for i, name in enumerate(("aid", "valid", "xyz")):
        assert torch.equal(ker[i], ref[i]), name
    torch.testing.assert_close(ker[3], ref[3], rtol=0, atol=1e-6)
    assert 0.05 < float(ref[1].float().mean()) < 0.95
    # probe mode: given points, one column per point
    xyz = ref[2].reshape(-1, 1, 3)
    zz, vv = z.reshape(-1, 1), rv[:, None].expand(R, K).reshape(-1)
    ker = trender.active_field_fwd(ms, T_CFG, ms.packed, None, None, zz, vv, xyz)
    ref2 = trender.active_field_fwd_plain(ms, T_CFG, ms.packed, None, None, zz, vv, xyz)
    for i in range(3):
        assert torch.equal(ker[i], ref2[i])
    torch.testing.assert_close(ker[3], ref2[3], rtol=0, atol=1e-6)
    assert torch.equal(ref2[1].reshape(R, K), ref[1])


def test_field_columns_autograd_on_card_matches_cpu(cuda):
    ms, o, d, tc = _case(cuda, seed=6)
    ht = trc.build_hit_table(ms, T_CFG, T_RC, o, d, tc)
    g = torch.Generator(device=cuda).manual_seed(6)
    u = trc.uniform_jitter((o.shape[0], 24), g, cuda)
    ez = torch.rand((o.shape[0], 8), generator=g, device=cuda) * 10.0
    rv = torch.ones((o.shape[0],), dtype=torch.bool, device=cuda)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        st = type(ms)(*[x.to(dev) for x in ms])
        packed = st.packed.clone().requires_grad_(True)
        oo = o.to(dev).clone().requires_grad_(True)
        dd = d.to(dev).clone().requires_grad_(True)
        h = trc.HitTable(*[x.to(dev) for x in ht])
        feats, *_ = trender.field_columns(packed, oo, dd, h, u.to(dev), T_CFG.voxel_size,
                                          (st, T_CFG, ez.to(dev), rv.to(dev)))
        (feats * torch.linspace(-1, 1, 16, device=dev)).sum().backward()
        grads[dev.type] = [x.grad.cpu() for x in (packed, oo, dd)]
    for k, c in zip(grads["cuda"], grads["cpu"]):
        assert float((k - c).abs().max()) <= 1e-5 * float(c.abs().max())


def _gn_inputs(device, N=512, MK=72, seed=0):
    rng = np.random.default_rng(seed)
    pcos = np.where(rng.uniform(size=N) < 0.6, rng.uniform(0.3, 0.99, N), 1.0)
    d_meas = rng.uniform(2.0, 30.0, N) * pcos
    z = (d_meas / pcos)[:, None] + rng.uniform(-3.0, 1.0, (N, MK))
    arr = dict(
        xyz=rng.normal(size=(N, MK, 3)) * 10.0, z=z, sdf=rng.uniform(-1, 1, (N, MK)),
        g=rng.normal(size=(N, MK, 3)), vmask=rng.uniform(size=(N, MK)) > 0.2, pcos=pcos,
        d_meas=d_meas, depth_ok=rng.uniform(size=N) > 0.02,
        bias_ray=np.where(pcos < 0.999, 0.02, -0.01), t_pos=rng.normal(size=3))
    return {k: torch.as_tensor(v if v.dtype == bool else v.astype(np.float32), device=device)
            for k, v in arr.items()}


def test_gn_system_kernel_matches_plain(cuda):
    tp = ttr.TrackParams(n_rays=512, num_iterations=1, truncation=0.3, max_depth=40.0,
                         fs_weight=1.0, sdf_weight=1e4)
    a = _gn_inputs(cuda)
    args = (a["xyz"], a["t_pos"], a["z"], a["sdf"], a["g"], a["vmask"], a["pcos"], a["d_meas"],
            a["depth_ok"], tp, a["bias_ray"])
    n0 = ttr.gn_system_launches
    H, b, loss = ttr.gn_system(*args)
    H2, b2, loss2 = ttr.gn_system(*args)
    rH, rb, rl = ttr.gn_system_plain(*args)
    torch.cuda.synchronize()
    assert ttr.gn_system_launches == n0 + 2
    assert torch.equal(H, H2) and torch.equal(b, b2) and torch.equal(loss, loss2)
    assert torch.equal(H, H.T)
    for k, r in ((H, rH), (b, rb), (loss, rl)):
        assert float((k.double() - r.double()).abs().max()) <= 1e-4 * float(r.abs().max())


def test_insert_kernel_matches_plain(cuda):
    ms, *_ = _case(cuda, seed=7)
    rng = np.random.default_rng(7)
    n = 6000
    pts = np.stack([rng.uniform(-6, 12, n), rng.uniform(-6, 6, n), rng.uniform(-3, 3, n)], -1)
    pts[:10] += 200.0  # out of region
    pts = torch.as_tensor(pts.astype(np.float32), device=cuda)
    val = torch.as_tensor(rng.uniform(size=n) > 0.05, device=cuda)
    ms = ms._replace(embeddings=ms.embeddings.to(torch.bfloat16))
    before = [t.clone() for t in ms]
    for cap, append in ((0, False), (700, True), (n, True)):
        n0 = vm.insert_launches
        ker = vm.insert_points(ms, T_CFG, pts, val, cap, append)
        ref = vm.insert_points_plain(ms, T_CFG, pts, val, cap, append)
        torch.cuda.synchronize()
        assert vm.insert_launches == n0 + 1
        for name in vm.MapState._fields:
            assert torch.equal(getattr(ker, name), getattr(ref, name)), (cap, name)
        assert int(ker.num_lat) > int(ms.num_lat) and int(ker.num_cand) > 700
    # the input state is untouched (the pipeline rewinds to it)
    assert all(torch.equal(a, b) for a, b in zip(before, ms))


def test_active_set_kernels_match_plain(cuda):
    ms, *_ = _case(cuda, seed=8)
    before = [t.clone() for t in ms]
    for cfg in (T_CFG, T_CFG._replace(active_cap=64)):  # the second truncates the set
        for center in ((0.0, 0.0, 0.0), (3.7, -1.2, 0.4)):
            c = torch.tensor(center, device=cuda)
            n0 = vm.active_set_launches
            kr, rr = vm.recenter(ms, cfg, c), vm.recenter_plain(ms, cfg, c)
            kf, rf = vm.refresh_active(kr, cfg), vm.refresh_active_plain(kr, cfg)
            torch.cuda.synchronize()
            assert vm.active_set_launches == n0 + 2
            for name in vm.MapState._fields:
                assert torch.equal(getattr(kr, name), getattr(rr, name)), (center, name)
                assert torch.equal(getattr(kf, name), getattr(rf, name)), (center, name)
        assert int(rf.n_active) > 64  # the true count, past a truncated set
    assert all(torch.equal(a, b) for a, b in zip(before, ms))


@pytest.mark.parametrize("emb_dtype", [torch.float32, torch.bfloat16])
def test_reconcile_kernel_matches_plain(cuda, emb_dtype):
    ms, *_ = _case(cuda, seed=9)
    ms = ms._replace(embeddings=ms.embeddings.to(emb_dtype))
    ms = ms._replace(packed=vm.pack_embeddings(ms, T_CFG))
    g = torch.Generator(device=cuda).manual_seed(9)
    A, n = ms.packed.shape[0], int(ms.n_active)
    touched = (torch.rand((A,), generator=g, device=cuda) < 0.5) & (
        torch.arange(A, device=cuda) < n)
    new_packed = ms.packed + 0.05 * torch.randn(ms.packed.shape, generator=g, device=cuda)
    cpu = vm.MapState(*[x.cpu() for x in ms])
    for cap in (A, max(int(touched.sum()) // 3, 1)):  # the second truncates the touched set
        n0 = vm.reconcile_launches
        k1 = vm.reconcile(ms, T_CFG, new_packed, touched, cap)
        k2 = vm.reconcile(ms, T_CFG, new_packed, touched, cap)
        ref = vm.reconcile_plain(cpu, T_CFG, new_packed.cpu(), touched.cpu(), cap)
        torch.cuda.synchronize()
        assert vm.reconcile_launches == n0 + 2
        for name in vm.Reconciled._fields:
            assert torch.equal(getattr(k1, name), getattr(k2, name)), (cap, name)
            assert torch.equal(getattr(k1, name).cpu(), getattr(ref, name)), (cap, name)
        assert not torch.equal(k1.embeddings, ms.embeddings)


def test_grid_sampler_kernels_match_plain(cuda):
    ms, o, d, tc = _case(cuda, seed=10)
    rc = T_RC._replace(sampler="grid", n_samples=32)
    n0 = (trc.march_occupancy_launches, trc.place_samples_cdf_launches)
    cdf, n_occ = trc.march_occupancy(ms, T_CFG, rc, o, d, tc)
    pcdf, pn = trc.march_occupancy_plain(ms, T_CFG, rc, o, d, tc)
    torch.cuda.synchronize()
    assert torch.equal(cdf, pcdf) and torch.equal(n_occ, pn)
    assert 0.3 < float((pn > 0).float().mean()) <= 1.0
    g = torch.Generator(device=cuda).manual_seed(10)
    u = trc.uniform_jitter((o.shape[0], rc.n_samples), g, cuda)
    o2 = (o + 0.02).contiguous()
    ker = trc.place_samples_cdf(ms, T_CFG, rc, pcdf, pn, o2, d, tc, u)
    ref = trc.place_samples_cdf_plain(ms, T_CFG, rc, pcdf, pn, o2, d, tc, u)
    torch.cuda.synchronize()
    assert (trc.march_occupancy_launches, trc.place_samples_cdf_launches) == (n0[0] + 1,
                                                                              n0[1] + 1)
    for i, name in ((1, "aid"), (2, "valid"), (3, "ray_mask")):
        assert torch.equal(ker[i], ref[i]), name
    ulp = torch.nextafter(ref[0], torch.full_like(ref[0], float("inf"))) - ref[0]
    assert bool(((ker[0] - ref[0]).abs() <= ulp).all())
    assert 0.2 < float(ref[2].float().mean()) < 1.0


def test_render_rays_grid_autograd_on_card_matches_cpu(cuda):
    ms, o, d, tc = _case(cuda, seed=11)
    rc = T_RC._replace(sampler="grid", n_samples=24)
    occ = trc.march_occupancy_plain(ms, T_CFG, rc, o, d, tc)
    g = torch.Generator(device=cuda).manual_seed(11)
    u = trc.uniform_jitter((o.shape[0], 24), g, cuda)
    ez = torch.rand((o.shape[0], 8), generator=g, device=cuda) * 10.0
    rv = torch.ones((o.shape[0],), dtype=torch.bool, device=cuda)
    params = {"w": [torch.randn((16, 32), generator=g, device=cuda) * 0.3,
                    torch.randn((32, 1), generator=g, device=cuda) * 0.3],
              "b": [torch.zeros(32, device=cuda), torch.zeros(1, device=cuda)]}
    grads, sdfs = {}, {}
    for dev in (cuda, torch.device("cpu")):
        st = type(ms)(*[x.to(dev) for x in ms])
        packed = st.packed.clone().requires_grad_(True)
        oo = o.to(dev).clone().requires_grad_(True)
        dd = d.to(dev).clone().requires_grad_(True)
        out = trender.render_rays(packed, {k: [w.to(dev) for w in v] for k, v in params.items()},
                                  st, T_CFG, rc, oo, dd, tc.to(dev), rv.to(dev),
                                  tuple(x.to(dev) for x in occ), u.to(dev),
                                  extra=(st, T_CFG, ez.to(dev), rv.to(dev)))
        torch.where(out.valid_mask, out.sdf, 0.0).sum().backward()
        grads[dev.type] = [x.grad.cpu() for x in (packed, oo, dd)]
        sdfs[dev.type] = out.sdf.detach().cpu()
    assert float((sdfs["cuda"] - sdfs["cpu"]).abs().max()) <= 1e-5
    for k, c in zip(grads["cuda"], grads["cpu"]):
        assert float((k - c).abs().max()) <= 1e-5 * float(c.abs().max())


@pytest.mark.parametrize("res", [2, 3, 4])
@pytest.mark.parametrize("emb_dtype", [torch.float32, torch.bfloat16])
def test_mesh_kernels_match_plain(cuda, res, emb_dtype):
    ms, *_ = _case(cuda, seed=res)
    ms = ms._replace(embeddings=ms.embeddings.to(emb_dtype))
    ids = vm.surface_voxel_ids(ms)
    assert ids.numel() > 100
    ids = torch.cat([ids, torch.full((37,), -1, dtype=torch.int32, device=cuda)])
    n0 = (tmesher.mesh_lattice_launches, tmarch.marching_tets_launches)
    kf, kp = tmesher.mesh_lattice(ms, T_CFG, ids, res)
    rf, rp = tmesher.mesh_lattice_plain(ms, T_CFG, ids, res)
    assert kf.shape == (ids.numel(), res ** 3, 16) and kp.shape == (ids.numel(), res ** 3, 3)
    assert torch.equal(kf, rf) and torch.equal(kp, rp)
    if res == 2:  # weights 0 / 1: the corner rows themselves
        rows = ms.embeddings[ms.corner_idx[ids.clamp(min=0).long()].clamp(min=0).long()].float()
        assert torch.equal(kf, rows)
    g = torch.Generator(device=cuda).manual_seed(res)
    sdf = rf @ torch.randn((16,), generator=g, device=cuda) + 0.05
    cct = torch.as_tensor(tmesher._cell_corner_table(res), device=cuda)
    kt, kv = tmarch.marching_tets_lattice(sdf, rp, cct, ids)
    rt, rv = tmarch.marching_tets_lattice_plain(sdf, rp, cct, ids)
    torch.cuda.synchronize()
    assert (tmesher.mesh_lattice_launches, tmarch.marching_tets_launches) == (n0[0] + 1,
                                                                              n0[1] + 1)
    assert kt.shape == (ids.numel() * (res - 1) ** 3, 12, 3, 3)
    assert torch.equal(kv, rv) and torch.equal(kt, rt)
    assert bool(rv.any()) and not bool(rv[-37 * (res - 1) ** 3:].any())


def test_marching_tets_cells_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    pos = (torch.rand((4096, 1, 3), generator=g, device=cuda)
           + 0.3 * torch.rand((4096, 8, 3), generator=g, device=cuda))
    val = 0.2 * torch.randn((4096, 8), generator=g, device=cuda)
    val[::7, 3] = 0.0
    val[5] = val[5, 0]
    kt, kv = tmarch.marching_tets_cells(pos, val)
    rt, rv = tmarch.marching_tets_cells_plain(pos, val)
    assert torch.equal(kv, rv) and torch.equal(kt, rt)
    assert 0.1 < float(rv.float().mean()) < 0.9


def _scan(device, n=20000, seed=0):
    """A sensor-frame scan of a floor and two walls, a LiDAR-like range
    window, with padding rows at the end."""
    rng = np.random.default_rng(seed)
    n3 = n // 3
    along = rng.uniform(-20, 20, (3, n3))
    floor = np.stack([along[0], rng.uniform(-6, 6, n3), np.full(n3, -2.0)], -1)
    wl = np.stack([along[1], np.full(n3, -6.0), rng.uniform(-2, 2, n3)], -1)
    wr = np.stack([along[2], np.full(n3, 6.0), rng.uniform(-2, 2, n3)], -1)
    pts = np.concatenate([floor, wl, wr]).astype(np.float32)
    d = np.linalg.norm(pts, axis=1)
    pts = pts[(d > 4.0) & (d < 25.0)]
    valid = rng.uniform(size=len(pts)) > 0.03
    pts = np.concatenate([pts, np.zeros((300, 3), np.float32)])
    valid = np.concatenate([valid, np.zeros(300, bool)])
    return torch.as_tensor(pts, device=device), torch.as_tensor(valid, device=device)


S2S = ts2s.Scan2ScanParams(weight=10.0, n_elev=32, n_az=256, gate_dist=1.0, huber=0.2,
                           min_depth=1.0, max_depth=50.0)


@pytest.mark.parametrize("sp", [S2S, S2S._replace(n_elev=64, n_az=1024)])
def test_build_prev_scan_kernel_matches_plain(cuda, sp):
    pts, valid = _scan(cuda)
    pose = torch.tensor([3.0, -1.0, 0.5, 0.02, -0.01, 0.3], device=cuda)
    n0 = ts2s.build_prev_scan_launches
    k1 = ts2s.build_prev_scan(sp, pts, valid, pose)
    k2 = ts2s.build_prev_scan(sp, pts, valid, pose)
    ref = ts2s.build_prev_scan_plain(sp, pts, valid, pose)
    torch.cuda.synchronize()
    assert ts2s.build_prev_scan_launches == n0 + 2
    for name in ts2s.PrevScan._fields:
        assert torch.equal(getattr(k1, name), getattr(k2, name)), f"{name} differs between calls"
        assert torch.equal(getattr(k1, name), getattr(ref, name)), name
    assert int(ref.pix_valid.sum()) > 300
    empty = ts2s.build_prev_scan(sp, pts, torch.zeros_like(valid), pose)
    assert not bool(empty.pix_valid.any()) and float(empty.elev_min) == 1e9


def test_s2s_system_kernel_matches_plain(cuda):
    pts, valid = _scan(cuda, seed=1)
    prev = ts2s.build_prev_scan_plain(S2S, pts, valid, torch.zeros(6, device=cuda))
    cur, _ = _scan(cuda, n=6000, seed=2)
    pose = torch.tensor([0.4, 0.1, 0.02, 0.0, 0.01, 0.02], device=cuda)
    cur = cur[:2048] - pose[:3]
    rv = torch.rand(len(cur), device=cuda) > 0.05
    n0 = ts2s.s2s_system_launches
    k1 = ts2s.s2s_system(S2S, prev, pose, cur, rv)
    k2 = ts2s.s2s_system(S2S, prev, pose, cur, rv)
    ref = ts2s.s2s_system_plain(S2S, prev, pose, cur, rv)
    torch.cuda.synchronize()
    assert ts2s.s2s_system_launches == n0 + 2
    assert float(torch.trace(ref[0][:3, :3])) > 1000
    for name, a, b, r in zip(("H", "b", "loss"), k1, k2, ref):
        assert torch.equal(a, b), f"{name} differs between two runs"
        assert float((a - r).abs().max()) <= 1e-5 * float(r.abs().max()), name
    assert torch.equal(k1[0], k1[0].T)


def test_wrappers_reject_other_devices():
    ms, o, d, tc = _case("cpu")
    meta = [x.to("meta") for x in (o, d, tc)]
    with pytest.raises(ValueError, match="unsupported device"):
        trc.build_hit_table(ms, T_CFG, T_RC, *meta)
    ht = trc.build_hit_table(ms, T_CFG, T_RC, o, d, tc)
    with pytest.raises(ValueError, match="unsupported device"):
        trender.hits_field_fwd(ht, torch.zeros(o.shape[0], 4), o, d, ms.packed.to("meta"), 0.5)
    with pytest.raises(ValueError, match="unsupported device"):
        trender.active_field_fwd(ms, T_CFG, ms.packed.to("meta"), o, d, torch.ones(len(o), 2),
                                 torch.ones(len(o), dtype=torch.bool))
    a = {k: v.to("meta") for k, v in _gn_inputs("cpu", N=4, MK=3).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        ttr.gn_system(a["xyz"], a["t_pos"], a["z"], a["sdf"], a["g"], a["vmask"], a["pcos"],
                      a["d_meas"], a["depth_ok"], None)
    with pytest.raises(ValueError, match="unsupported device"):
        vm.insert_points(ms, T_CFG, o.to("meta"), torch.ones(len(o), dtype=torch.bool))
    ms_meta = type(ms)(*[x.to("meta") for x in ms])
    with pytest.raises(ValueError, match="unsupported device"):
        vm.recenter(ms_meta, T_CFG, torch.zeros(3, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        vm.refresh_active(ms_meta, T_CFG)
    with pytest.raises(ValueError, match="unsupported device"):
        vm.reconcile(ms, T_CFG, ms.packed.to("meta"), torch.ones(len(ms.packed), dtype=torch.bool),
                     8)
    with pytest.raises(ValueError, match="unsupported device"):
        trc.march_occupancy(ms, T_CFG, T_RC, *meta)
    with pytest.raises(ValueError, match="unsupported device"):
        trc.place_samples_cdf(ms, T_CFG, T_RC, torch.zeros(len(o), 4), torch.ones(len(o)),
                              *meta, torch.zeros(len(o), 4))
    with pytest.raises(ValueError, match="unsupported device"):
        tmesher.mesh_lattice(ms, T_CFG, torch.zeros(4, dtype=torch.int32, device="meta"), 2)
    with pytest.raises(ValueError, match="unsupported device"):
        tmarch.marching_tets_cells(torch.zeros(4, 8, 3, device="meta"),
                                   torch.zeros(4, 8, device="meta"))
    pts, valid = _scan("cpu", n=600)
    with pytest.raises(ValueError, match="unsupported device"):
        ts2s.build_prev_scan(S2S, pts.to("meta"), valid.to("meta"), torch.zeros(6, device="meta"))
    prev = ts2s.build_prev_scan(S2S, pts, valid, torch.zeros(6))
    with pytest.raises(ValueError, match="unsupported device"):
        ts2s.s2s_system(S2S, prev, torch.zeros(6), pts.to("meta"), valid.to("meta"))


def test_kernel_library_is_built_lazily():
    # importing the port builds nothing; one library per source, its name
    # carrying a hash of that source
    srcs = kernels.sources()
    assert {os.path.basename(s) for s in srcs} >= {
        "hit_table.cu", "hits_field.cu", "active_field.cu", "gn_system.cu", "insert.cu",
        "active_set.cu", "reconcile.cu", "grid_sampler.cu", "mesh.cu", "scan2scan.cu"}
    paths = [kernels.library_path(s) for s in srcs]
    assert len(set(paths)) == len(srcs)
    for path in paths:
        assert os.path.dirname(path) == kernels.BUILD_DIR
        assert len(os.path.basename(path).split("_")[-1]) == len("0123456789abcdef.so")
    assert kernels._lib is None or torch.cuda.is_available()
    assert "-fmad=false" in kernels.NVCC_FLAGS and "--use_fast_math" not in kernels.NVCC_FLAGS
