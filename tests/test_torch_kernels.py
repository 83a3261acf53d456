"""The port's CUDA kernels (K4 hit table, K1 hits field, K2 its backward,
K8 active field, K3 GN normal equations, K7 voxel insert, K6 recenter +
active set, K5 reconcile + repack, E1 pack_embeddings and its transpose,
K9a occupancy march, K9b CDF
placement, K10a mesh lattice, K10b marching tetrahedra, K11a range image,
K11b point-to-plane system, the ray setup ray_prep, the LM update lm_step,
K3's dp form, csrc/trig.cu, glibc's sin, cos and atan2, and
csrc/exp_so3.cu, the rotations of the se3 ops)
against their plain torch twins, at small shapes. On a machine
without CUDA these tests skip (the `cuda` fixture decides, at run time);
run them on the card with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py`
(the file imports neither jax nor the repo's conftest, which imports jax:
the card's machine has no jax). The CPU-only checks at the end run
everywhere.

Tolerances as in chip_smoke.py: integers, depths and positions exact (the
kernels round exactly like the plain ops: no FMA contraction, IEEE
division; also with one origin expanded to every ray, and for K1 at 1 to
2,000 samples a ray and 20 or 64 hit slots); K4's cdf the running f32
sum of the twin's seg column by column (1e-5 relative to the twin's
torch.cumsum) at 1 to 64 hit slots, and its packed rows pack_hit_table
of its table; features 1e-6; d
xyz 1e-5 relative; d packed 1e-5 of its largest entry (another summation
order than the twin's), bit-identical between two calls and equal to
render.dpacked_in_row_order_plain (each row adds its samples in ascending
index, in the kernel's arithmetic) whatever a row's sample count, and with
no valid sample at all; K8 integers and
positions exact, features 1e-6, the same bits from call to call of one
ActiveField and with one origin expanded to every ray (read as it is: one
kernel, no copy); K3 H, b and loss 1e-4 relative (another summation
order), bit-stable from run to run, a GnSystem made once equal to a fresh
one, one kernel a call, and its last-block counter back to zero after
calls of every size (below one block, rays not a multiple of a block's
warps, an all-false mask); K7 (in place) every table and its record
equal to the in-place twin's (both elect the smallest slot), between two
calls from equal clones and with the candidate cap overflowed, its kept
election grids all INT_MAX after every call and its undo exact; K6
every table equal (f32 and bf16); K5
every table equal to the twin run on the CPU (f32 and bf16, "mean" and
"sum": both add each corner's deltas in ascending order, rounding after
every add) and bit-identical between calls without a scratch and
through one kept ReconcileScratch, whose head table is all -1 after
every call; E1's forward equal to pack_embeddings and its transpose to
pack_embeddings_vjp_plain on the CPU (padding rows, -1 corners, corners
shared by 8 voxels, a list longer than 8), bit-identical between two
calls through one PackGradScratch, its head table all -1 after every
build, rebuilt for a grown map, and through PackEmbeddings' autograd
equal to the CPU's; K9a cdf and n_occ equal,
also launched as part of making a placer (CdfPlacer.march) with one
origin per ray and with one expanded to every ray, one CUDA launch a
march and no copy; K9b aid, valid and ray_mask
equal and z within one f32 ulp (also with one origin broadcast to every
ray and widths that are not multiples of 32); the grid render's gradients on the card
1e-5 of the CPU's largest entry (another summation order); K10a features and
positions equal, K10b triangles and mask equal (one rounded operation at a
time on both sides), and its compact form's T and triangles equal to the
twin's tris[valid] (T = 0, many tiles, runs of empty tiles between full
ones, -1 padding ids; two calls through one TetScratch equal and its tile
states and tickets left all zero; one CUDA launch a call); K11a every output equal and bit-identical between two
calls (per-pixel sums in ascending point index), one launch of the port's
a call; K11b H, b and loss 1e-5
relative (another summation order) and bit-stable from run to run, and in
the accumulating form each entry one add on the sums alone (also into a
GnSystem's own outputs, as the tracker calls it). K9b, K11b, K1, K2, K3's
GnSystem, K8's ActiveField, K4, K5, K9a's CdfPlacer.march and K10b
raise on what they would have to convert (another device, another dtype,
a strided tensor). ray_prep every output equal to its twin on the card
and on the CPU (and in BA's (W, K, 3) form); lm_step's translation and
small-angle half equal to its twin's on the card and on the CPU, the
rest's rotation within 4 ulp of each pose's largest entry (CUDA's sinf
and atan2f), its rotation matrix within 4 ulp of 1 of the twin's, its
one-step form the batch's row; both raise on what they cannot take."""

import ctypes
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
from nerfloam_tpu_torch.ops import ieee
from nerfloam_tpu_torch.ops import interp as tinterp
from nerfloam_tpu_torch.ops import marching as tmarch
from nerfloam_tpu_torch.ops import raycast as trc
from nerfloam_tpu_torch.ops import se3 as tse3
from nerfloam_tpu_torch.ops import trig

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
    ms, _ = vm.insert_points(ms, T_CFG, pts, torch.ones(len(pts), dtype=torch.bool))
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


D_CFG = vm.MapConfig(capacity=1 << 16, grid_dim=(128, 32, 32), voxel_size=0.25)


def _dense_case(device, R=160, seed=0):
    """A solid block of surface voxels along most of the region's x extent
    (a ray along it crosses ~100 of them, more than any table holds), and
    rays from just outside it: a fifth pointing away (no hit), the others
    along the block with ranges of 1 to 40 m (past the region's end at x =
    16 m, 31.5 m away: some rays leave the region)."""
    vs = D_CFG.voxel_size
    g = np.meshgrid(np.arange(-14, 14, vs), np.arange(-1.5, 1.5, vs), np.arange(-1.5, 1.5, vs),
                    indexing="ij")
    pts = torch.as_tensor(np.stack([x.ravel() + vs / 2 for x in g], -1), dtype=torch.float32)
    ms = vm.recenter(vm.create(D_CFG, "cpu"), D_CFG, torch.zeros(3))
    ms = vm.refresh_active(
        vm.insert_points(ms, D_CFG, pts, torch.ones(len(pts), dtype=torch.bool))[0], D_CFG)
    rng = np.random.default_rng(seed)
    o = np.stack([np.full(R, -15.5), rng.uniform(-1, 1, R), rng.uniform(-1, 1, R)], -1)
    d = np.stack([np.where(rng.uniform(size=R) < 0.2, -1.0, 1.0), rng.uniform(-0.15, 0.15, R),
                  rng.uniform(-0.15, 0.15, R)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_cap = rng.uniform(1.0, 40.0, R)
    ms = type(ms)(*[x.to(device) for x in ms])
    return ms, *(torch.as_tensor(x, dtype=torch.float32, device=device) for x in (o, d, t_cap))


@pytest.mark.parametrize("H", [1, 20, 33, 64])
def test_hit_table_kernel_matches_plain(cuda, H):
    """K4 on the two walls (24 probes) and on the dense block (150 probes,
    rays with no hit, with more than H hits, and leaving the region), with
    one origin per ray and with one origin expanded to every ray (row
    stride 0, read as it is), unpacked and packed: every output equal to
    the twin, cdf to the running f32 sum of the twin's seg column by
    column, the packed rows to pack_hit_table of the table; one launch a
    call."""
    dense_rc = T_RC._replace(max_hits=H, n_coarse=150, coarse_step=0.27, voxel_size=0.25,
                             max_depth=40.0)
    for cfg, rc, (ms, o, d, tc) in ((T_CFG, T_RC._replace(max_hits=H), _case(cuda)),
                                    (D_CFG, dense_rc, _dense_case(cuda))):
        for label, ro in (("origin per ray", o), ("origin row stride 0", o[:1].expand_as(d))):
            n0 = trc.hit_table_launches
            ker = trc.build_hit_table(ms, cfg, rc, ro, d, tc)
            kp = trc.build_hit_table_packed(ms, cfg, rc, ro, d, tc)
            ref = trc.build_hit_table_plain(ms, cfg, rc, ro, d, tc)
            torch.cuda.synchronize()
            assert trc.hit_table_launches == n0 + 2
            for name in ("aid", "cell", "ray_mask", "t_near", "seg"):
                assert torch.equal(getattr(ker, name), getattr(ref, name)), (label, name)
            acc, cols = torch.zeros_like(ref.seg[:, 0]), []
            for h in range(H):
                acc = acc + ref.seg[:, h]
                cols.append(acc)
            assert torch.equal(ker.cdf, torch.stack(cols, 1)), label
            torch.testing.assert_close(ker.cdf, ref.cdf, rtol=1e-5, atol=0)
            assert torch.equal(kp, trc.pack_hit_table(ker)), label
            assert bool(ker.ray_mask.any())
        if cfg is D_CFG:
            ends = o[:, 0] + d[:, 0] * (tc + rc.coarse_step)
            assert bool((~ref.ray_mask).any()) and bool((ref.aid[:, -1] >= 0).any())
            assert bool((ref.ray_mask & (ends > 16.0)).any())  # hits, then out of the region


@pytest.mark.parametrize("M", [24, 48])
def test_hits_field_kernels_match_plain(cuda, M):
    ms, o, d, tc = _case(cuda, seed=M)
    ht = trc.build_hit_table_plain(ms, T_CFG, T_RC, o, d, tc)
    g = torch.Generator(device=cuda).manual_seed(M)
    u = trc.uniform_jitter((o.shape[0], M), g, cuda)
    o2 = (o + 0.02).contiguous()
    n0 = trender.hits_field_fwd_launches
    ker = trender.hits_field_fwd(ht, u, o2, d, ms.packed, T_CFG.voxel_size)
    ref = trender.hits_field_fwd_plain(ht, u, o2, d, ms.packed, T_CFG.voxel_size)
    for i, name in enumerate(("z", "valid", "aid", "xyz")):
        assert torch.equal(ker[i], ref[i]), name
    torch.testing.assert_close(ker[4], ref[4], rtol=0, atol=1e-6)
    # one origin for every ray, row stride 0 (the trackers' form)
    o1 = o2[:1].expand_as(d)
    ker1 = trender.hits_field_fwd(ht, u, o1, d, ms.packed, T_CFG.voxel_size)
    ref1 = trender.hits_field_fwd_plain(ht, u, o1, d, ms.packed, T_CFG.voxel_size)
    for i, name in enumerate(("z", "valid", "aid", "xyz")):
        assert torch.equal(ker1[i], ref1[i]), name
    torch.testing.assert_close(ker1[4], ref1[4], rtol=0, atol=1e-6)
    assert trender.hits_field_fwd_launches == n0 + 2
    _, valid, aid, xyz, _ = ref
    dfeats = torch.randn((o.shape[0], M, 16), generator=g, device=cuda)
    kx, kp = trender.hits_field_bwd(dfeats, xyz, aid, valid, ms.packed, T_CFG.voxel_size)
    rx, rp = trender.hits_field_bwd_plain(dfeats, xyz, aid, valid, ms.packed, T_CFG.voxel_size,
                                          True)
    assert float((kx - rx).abs().max()) <= 1e-5 * float(rx.abs().max())
    assert float((kp - rp).abs().max()) <= 1e-5 * float(rp.abs().max())
    # each row's samples added in ascending index, in the kernel's arithmetic
    assert torch.equal(kp, trender.dpacked_in_row_order_plain(dfeats, xyz, aid, valid, len(kp),
                                                              T_CFG.voxel_size))
    # no float atomics: the same every run, with a scratch of its own or one kept
    sc = trender.DpackedScratch()
    for _ in range(2):
        kx2, kp2 = trender.hits_field_bwd(dfeats, xyz, aid, valid, ms.packed, T_CFG.voxel_size,
                                          scratch=sc)
        assert torch.equal(kx, kx2) and torch.equal(kp, kp2)
    untouched = torch.ones(len(kp), dtype=torch.bool, device=cuda)
    untouched[aid[valid].long()] = False
    assert float(kp[untouched].abs().max()) == 0.0 and bool(untouched.any())
    gx, none = trender.hits_field_bwd(dfeats, xyz, aid, valid, ms.packed, T_CFG.voxel_size,
                                      want_dpacked=False)
    assert none is None and torch.equal(gx, kx)


@pytest.mark.parametrize("long_len", [0, 300, 1200, 5000])
def test_hits_field_bwd_segments_match_row_order(cuda, long_len):
    """K2's d packed equal to its oracle whatever a row's sample count: a
    warp's rows (<= 64 samples), a block's in shared memory (<= 4096) and
    the in-place sort beyond it; long_len 0: no valid sample at all."""
    rng = np.random.default_rng(long_len)
    R, M, A = 512, 16, 300
    xyz = torch.as_tensor(rng.uniform(-4, 4, (R, M, 3)).astype(np.float32), device=cuda)
    aid = rng.integers(0, A, (R, M)).astype(np.int32)
    valid = rng.uniform(size=(R, M)) < (0.7 if long_len else 0.0)
    if long_len:
        pick = rng.choice(R * M, long_len, replace=False)
        aid.reshape(-1)[pick], valid.reshape(-1)[pick] = 7, True
    aid, valid = torch.as_tensor(aid, device=cuda), torch.as_tensor(valid, device=cuda)
    dfeats = torch.as_tensor(rng.normal(size=(R, M, 16)).astype(np.float32), device=cuda)
    packed = torch.as_tensor(rng.normal(size=(A, 128)).astype(np.float32), device=cuda)
    sc = trender.DpackedScratch()
    kx, kp = trender.hits_field_bwd(dfeats, xyz, aid, valid, packed, VS, scratch=sc)
    ref = trender.dpacked_in_row_order_plain(dfeats, xyz, aid, valid, A, VS)
    assert torch.equal(kp, ref)
    kx2, kp2 = trender.hits_field_bwd(dfeats, xyz, aid, valid, packed, VS, scratch=sc)
    assert torch.equal(kx, kx2) and torch.equal(kp, kp2)
    rx, _ = trender.hits_field_bwd_plain(dfeats, xyz, aid, valid, packed, VS, False)
    assert float((kx - rx).abs().max()) <= 1e-5 * max(float(rx.abs().max()), 1e-30)
    if long_len:
        assert int((aid[valid] == 7).sum()) >= long_len
    else:
        assert not bool(kp.any()) and not bool(kx.any())


@pytest.mark.parametrize("M,H", [(1, 20), (4, 64), (2000, 20)])
def test_hits_field_fwd_any_samples_and_slots(cuda, M, H):
    """K1 at shapes whose rays' tables do not fit 128 / M to a block in
    48 KB: fewer rays a block, and one ray beyond 48 KB (M = 2000) asks
    for more shared memory."""
    ms, o, d, tc = _case(cuda, R=40, seed=M)
    rc = trc.RaycastConfig(step_world=0.25 * VS, n_slots=97, n_samples=M, voxel_size=VS,
                           max_depth=12.0, sampler="hits", max_hits=H)
    ht = trc.build_hit_table_plain(ms, T_CFG, rc, o, d, tc)
    u = trc.uniform_jitter((o.shape[0], M), torch.Generator(device=cuda).manual_seed(M), cuda)
    ker = trender.hits_field_fwd(ht, u, o, d, ms.packed, VS)
    ref = trender.hits_field_fwd_plain(ht, u, o, d, ms.packed, VS)
    for i, name in enumerate(("z", "valid", "aid", "xyz")):
        assert torch.equal(ker[i], ref[i]), name
    torch.testing.assert_close(ker[4], ref[4], rtol=0, atol=1e-6)
    assert bool(ref[1].any())


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
    ker = ker0 = trender.active_field_fwd(ms, T_CFG, ms.packed, o, d, z, rv)
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
    # an ActiveField made once, called again: the same bits as the function form
    field = trender.ActiveField(ms, T_CFG)
    for _ in range(2):
        again = field(ms.packed, o, d, z, rv)
        assert all(torch.equal(a, b) for a, b in zip(again, ker0))
    assert trender.active_field_fwd_launches == n0 + 4


def _launches_per_call(fn, reps=5, sessions=3):
    """{device kernel or copy: launches per call of fn}, from torch.profiler
    over ``reps`` calls after a discarded warm-up step (a cold session drops
    kernel records; a session that still misses some is run again). Work
    seen fewer than ``reps`` times is the profiler's own."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     acc_events=True) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        got = {e.key: e.count / reps for e in prof.key_averages()
               if "CUDA" in str(getattr(e, "device_type", "")) and e.count >= reps}
        if got and all(float(n).is_integer() for n in got.values()):
            return got
    return got


@pytest.mark.parametrize("K", [1, 8, 64])
def test_active_field_shared_origin_read_as_it_is(cuda, K):
    """The trackers' form: one origin expanded to every ray (row stride 0)
    is read without a copy (one kernel, no other device work), with aid,
    valid and xyz equal to the twin's and the same bits as the origin
    copied out per ray."""
    ms, o, d, tc = _case(cuda, R=160, seed=K)
    g = torch.Generator(device=cuda).manual_seed(K)
    z = torch.rand((len(o), K), generator=g, device=cuda) * 11.0
    rv = torch.rand((len(o),), generator=g, device=cuda) > 0.1
    o1 = (o[3] + 0.01).expand_as(d)
    field = trender.ActiveField(ms, T_CFG)
    ker = field(ms.packed, o1, d, z, rv)
    ref = trender.active_field_fwd_plain(ms, T_CFG, ms.packed, o1, d, z, rv)
    copied = field(ms.packed, o1.contiguous(), d, z, rv)
    torch.cuda.synchronize()
    for i, name in enumerate(("aid", "valid", "xyz")):
        assert torch.equal(ker[i], ref[i]), name
    torch.testing.assert_close(ker[3], ref[3], rtol=0, atol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(ker, copied))
    assert bool(ref[1].any())
    launched = _launches_per_call(lambda: field(ms.packed, o1, d, z, rv))
    assert len(launched) == 1 and "active_field_fwd_kernel" in next(iter(launched)), launched
    assert list(launched.values()) == [1.0], launched


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
                                          (trender.ActiveField(st, T_CFG), ez.to(dev),
                                           rv.to(dev)))
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
    # a GnSystem made once (a tracker's frame): the same bits, call after
    # call, as a fresh one; its outputs are its own, overwritten in place
    system = ttr.GnSystem(a["pcos"], a["d_meas"], a["depth_ok"], a["bias_ray"], tp, 72)
    samples = (a["xyz"], a["t_pos"], a["z"], a["sdf"], a["g"], a["vmask"])
    out = system(*samples)
    for _ in range(2):
        again = system(*samples)
        assert all(x is y for x, y in zip(again, out))
        assert torch.equal(again[0], H) and torch.equal(again[1], b) and torch.equal(again[2], loss)
    assert ttr.gn_system_launches == n0 + 5
    launched = _launches_per_call(lambda: system(*samples))
    assert len(launched) == 1 and "gn_system_kernel" in next(iter(launched)), launched
    assert list(launched.values()) == [1.0], launched


def test_gn_system_dp_form_matches_plain(cuda):
    """K3's dp form (GnSystem(sums=True)): its 58 sums bit-stable between
    calls, the counts equal to gn_sums_plain's and each class's sums 1e-4
    relative; gn_combine of them 1e-4 relative of the one-launch form;
    one kernel a call, its counter back to zero."""
    tp = ttr.TrackParams(n_rays=512, num_iterations=1, truncation=0.3, max_depth=40.0,
                         fs_weight=1.0, sdf_weight=1e4)
    a = _gn_inputs(cuda)
    per_ray = (a["pcos"], a["d_meas"], a["depth_ok"], a["bias_ray"])
    samples = (a["xyz"], a["t_pos"], a["z"], a["sdf"], a["g"], a["vmask"])
    n0 = ttr.gn_sums_launches
    system = ttr.GnSystem(*per_ray, tp, 72, sums=True)
    ks = system(*samples).clone()
    assert torch.equal(system(*samples), ks) and ttr.gn_sums_launches == n0 + 2
    assert int(system._scratch[-1:].view(torch.int32)) == 0
    rs = ttr.gn_sums_plain(*samples, *per_ray[:3], tp, per_ray[3])
    assert torch.equal(ks[56:], rs[56:])
    for sl in (slice(0, 28), slice(28, 56)):
        assert float((ks[sl].double() - rs[sl].double()).abs().max()) <= 1e-4 * float(
            rs[sl].abs().max())
    one = ttr.GnSystem(*per_ray, tp, 72)(*samples)
    for k, r in zip(ttr.gn_combine(ks, tp), one):
        assert float((k.double() - r.double()).abs().max()) <= 1e-4 * float(r.abs().max())
    launched = _launches_per_call(lambda: system(*samples))
    assert list(launched.values()) == [1.0] and "gn_system_kernel" in next(iter(launched))


@pytest.mark.parametrize("sums", [False, True])
def test_gn_system_maturity_form_matches_plain(cuda, sums):
    """K3's maturity form (GnSystem(..., cnt=) called with the samples'
    active rows): one launch a call, bit-stable, within 1e-4 of the
    weighted twin (gn_system_plain / gn_sums_plain under
    maturity_weights), the dp form's counts unweighted; a sample whose
    aid is -1 reads the first row's count, as JAX's clip does."""
    tp = ttr.TrackParams(n_rays=512, num_iterations=1, truncation=0.3, max_depth=40.0,
                         fs_weight=1.0, sdf_weight=1e4, maturity_warmup=4, maturity_floor=0.25)
    a = _gn_inputs(cuda)
    per_ray = (a["pcos"], a["d_meas"], a["depth_ok"], a["bias_ray"])
    samples = (a["xyz"], a["t_pos"], a["z"], a["sdf"], a["g"], a["vmask"])
    g = torch.Generator().manual_seed(2)
    A = 300
    cnt = torch.randint(0, 9, (A,), generator=g).float().to(cuda)
    aid = torch.randint(-1, A, (512, 72), generator=g).to(torch.int32).to(cuda)
    n0 = ttr.gn_maturity_launches
    system = ttr.GnSystem(*per_ray, tp, 72, sums=sums, cnt=cnt)
    out = [x.clone() for x in ((system(*samples, aid),) if sums else system(*samples, aid))]
    again = (system(*samples, aid),) if sums else system(*samples, aid)
    torch.cuda.synchronize()
    assert ttr.gn_maturity_launches == n0 + 2
    assert all(torch.equal(x, y) for x, y in zip(out, again))
    assert int(system._scratch[-1:].view(torch.int32)) == 0
    w = ttr.maturity_weights(cnt, aid, tp)
    if sums:
        rs = ttr.gn_sums_plain(*samples, *per_ray[:3], tp, per_ray[3], w)
        assert torch.equal(out[0][56:], rs[56:])
        for sl in (slice(0, 28), slice(28, 56)):
            assert float((out[0][sl].double() - rs[sl].double()).abs().max()) <= 1e-4 * float(
                rs[sl].abs().max())
    else:
        ref = ttr.gn_system_plain(*samples, *per_ray[:3], tp, per_ray[3], w)
        for k, r in zip(out, ref):
            assert float((k.double() - r.double()).abs().max()) <= 1e-4 * float(r.abs().max())
    launched = _launches_per_call(lambda: system(*samples, aid))
    assert list(launched.values()) == [1.0] and "gn_system_kernel" in next(iter(launched))


@pytest.mark.parametrize("op", ["sin", "cos", "atan2"])
def test_trig_kernel_matches_host_copies(cuda, op):
    """csrc/trig.cu bit-equal to the host copies (native/trig.cpp) on 2^20
    seeded arguments over every magnitude, a column read at its stride,
    and its backward equal to the CPU's; one launch a call."""
    g = torch.Generator().manual_seed(3)
    bits = torch.randint(0, 2 ** 31 - 1, (1 << 20, 2), generator=g, dtype=torch.int64)
    x = bits.to(torch.int32).view(torch.float32) * torch.where(
        torch.rand((1 << 20, 2), generator=g) < 0.5, -1.0, 1.0)
    x[: 1 << 19] = torch.randn((1 << 19, 2), generator=g) * 4.0
    fn = {"sin": trig.sin, "cos": trig.cos, "atan2": trig.atan2}[op]
    on_card = x.to(cuda)
    args = (on_card[:, 0], on_card[:, 1]) if op == "atan2" else (on_card[:, 0],)
    n0 = trig.trig_launches
    got = fn(*args).cpu()  # strided columns, read as they are
    ref = fn(*(t.cpu().contiguous() for t in args))
    assert trig.trig_launches == n0 + 1
    same = (got.view(torch.int32) == ref.view(torch.int32)) | (got.isnan() & ref.isnan())
    assert bool(same.all()), int((~same).sum())
    a = [t[: 1 << 19].contiguous() for t in args]
    gr = torch.randn(1 << 19, generator=g)
    second = a[1] if op == "atan2" else None
    k = trig._launch_bwd(getattr(trig, op.upper()), a[0], second, gr.to(cuda))
    r = trig._bwd_plain(getattr(trig, op.upper()), a[0].cpu(),
                        None if second is None else second.cpu(), gr)
    assert all(torch.equal(u.cpu(), v) for u, v in zip(k, r) if v is not None)
    launched = _launches_per_call(lambda: fn(*a))
    assert list(launched.values()) == [1.0] and "trig_fwd_kernel" in next(iter(launched))


def test_exp_so3_kernel_matches_plain(cuda):
    """csrc/exp_so3.cu: the forward torch.equal to the chain of ops on the
    CPU (se3.exp_so3_plain) in the series, small and large ranges of
    theta^2, a pose's [3:6] read in place; the backward within 1e-5 of each
    gradient's largest entry of autograd's through the chain; one launch
    each way."""
    g = torch.Generator().manual_seed(5)
    d = torch.randn((3 * 4096, 3), generator=g)
    t2 = torch.cat([torch.rand(4096, generator=g) * 1e-8, torch.rand(4096, generator=g) * 1e-2,
                    torch.rand(4096, generator=g) * 9.0])
    w = d / d.norm(dim=-1, keepdim=True) * t2.sqrt()[:, None]
    poses = torch.cat([torch.randn((len(w), 3), generator=g), w], 1)
    G = torch.randn((len(w), 3, 3), generator=g)
    pk = poses.to(cuda).requires_grad_(True)
    n0 = tse3.exp_so3_launches
    R = tse3.pose_rotation(pk)
    (gk,) = torch.autograd.grad(R, pk, G.to(cuda))
    assert tse3.exp_so3_launches == n0 + 2
    pc = poses.clone().requires_grad_(True)
    Rc = tse3.exp_so3_plain(pc[:, 3:6])
    (gc,) = torch.autograd.grad(Rc, pc, G)
    assert torch.equal(R.detach().cpu(), Rc.detach())
    rel = (gk.cpu() - gc)[:, 3:].abs().amax(-1) / gc[:, 3:].abs().amax(-1).clamp_min(1e-30)
    assert float(rel.max()) <= 1e-5, float(rel.max())
    launched = _launches_per_call(lambda: tse3.pose_rotation(pk.detach()))
    assert list(launched.values()) == [1.0] and "exp_so3_fwd_kernel" in next(iter(launched))


@pytest.mark.parametrize("N,MK,masked", [(2, 3, True), (1000, 37, True), (512, 72, False),
                                         (2048, 72, True), (3000, 40, True)])
def test_gn_system_counter_returns_to_zero(cuda, N, MK, masked):
    """K3's last-block counter is zero after every call, whatever the size:
    below one block (2 x 3), rays not a multiple of a block's warps
    (1000, 3000: more rays than two blocks an SM take), an all-false mask;
    calls of different sizes through two objects in turn give the bits of a
    fresh object and stay within 1e-4 relative of the twin."""
    tp = ttr.TrackParams(n_rays=N, num_iterations=1, truncation=0.3, max_depth=40.0,
                         fs_weight=1.0, sdf_weight=1e4)
    a = _gn_inputs(cuda, N=N, MK=MK, seed=N + MK)
    if not masked:
        a["vmask"] = torch.zeros_like(a["vmask"])
    small = _gn_inputs(cuda, N=3, MK=5, seed=1)
    systems = [ttr.GnSystem(x["pcos"], x["d_meas"], x["depth_ok"], x["bias_ray"], tp, mk)
               for x, mk in ((a, MK), (small, 5))]
    rays = ("xyz", "t_pos", "z", "sdf", "g", "vmask")
    fresh = ttr.gn_system(*(a[k] for k in ("xyz", "t_pos", "z", "sdf", "g", "vmask", "pcos",
                                           "d_meas", "depth_ok")), tp, a["bias_ray"])
    fresh = [x.clone() for x in fresh]
    for _ in range(3):
        for system, x in zip(systems, (a, small)):
            system(*(x[k] for k in rays))
            torch.cuda.synchronize()
            assert int(system._scratch[-1:].view(torch.int32)) == 0
        got = systems[0](*(a[k] for k in rays))
        assert all(torch.equal(g_, f_) for g_, f_ in zip(got, fresh))
    ref = ttr.gn_system_plain(*(a[k] for k in ("xyz", "t_pos", "z", "sdf", "g", "vmask", "pcos",
                                               "d_meas", "depth_ok")), tp, a["bias_ray"])
    for k, r in zip(got, ref):
        assert float((k.double() - r.double()).abs().max()) <= 1e-4 * max(
            float(r.abs().max()), 1e-30)
    if not masked:
        assert not bool(got[0].any()) and not bool(got[1].any()) and float(got[2]) == 0.0


def _clone(ms):
    return vm.MapState(*[t.clone() for t in ms])


@pytest.mark.parametrize("emb_dtype", [torch.float32, torch.bfloat16])
def test_insert_kernel_matches_plain(cuda, emb_dtype):
    """K7 in place, each call on its own clone of one state: every table and
    the record equal to the in-place twin's (both elect the smallest slot),
    with and without the active-set append and with the candidate cap
    overflowed; two calls from equal clones equal; the kept scratch's
    election grids all INT_MAX after every call; the undo on the card
    gives back the pre-insert tables exactly; four launches a call."""
    ms, *_ = _case(cuda, seed=7)
    rng = np.random.default_rng(7)
    n = 6000
    pts = np.stack([rng.uniform(-6, 12, n), rng.uniform(-6, 6, n), rng.uniform(-3, 3, n)], -1)
    pts[:10] += 200.0  # out of region
    pts = torch.as_tensor(pts.astype(np.float32), device=cuda)
    val = torch.as_tensor(rng.uniform(size=n) > 0.05, device=cuda)
    ms = ms._replace(embeddings=ms.embeddings.to(emb_dtype))
    scratch = vm.InsertScratch()
    for cap, append in ((0, False), (700, True), (n, True), (0, True)):
        a, b, c = _clone(ms), _clone(ms), _clone(ms)
        n0 = vm.insert_launches
        ker, rec = vm.insert_points(a, T_CFG, pts, val, cap, append, scratch=scratch)
        ker2, rec2 = vm.insert_points(b, T_CFG, pts, val, cap, append, scratch=scratch)
        ref, rec_ref = vm.insert_points_plain(c, T_CFG, pts, val, cap, append)
        torch.cuda.synchronize()
        assert vm.insert_launches == n0 + 2
        assert ker is a and all(x.data_ptr() == y.data_ptr() for x, y in zip(ker, a))
        assert bool((scratch.grids == vm._INT_MAX).all())
        for name in vm.MapState._fields:
            assert torch.equal(getattr(ker, name), getattr(ref, name)), (cap, name)
            assert torch.equal(getattr(ker, name), getattr(ker2, name)), (cap, name)
        parts = [vm.record_parts(r) for r in (rec, rec2, rec_ref)]
        for name in parts[0]:
            assert torch.equal(parts[0][name], parts[2][name]), (cap, name)
            assert torch.equal(parts[0][name], parts[1][name]), (cap, name)
        assert int(ker.num_lat) > int(ms.num_lat) and int(ker.num_cand) > 700
        h = parts[0]["header"].tolist()
        assert h[4] > 0 and h[5] == (h[4] if append else 0)
        n1 = vm.insert_undo_launches
        vm.undo_insert(ker, rec)
        torch.cuda.synchronize()
        assert vm.insert_undo_launches == n1 + 1
        for name in vm.MapState._fields:
            assert torch.equal(getattr(a, name), getattr(ms, name)), (cap, name)


def test_insert_scratch_grows_and_stays_reset(cuda):
    """One InsertScratch over inserts of growing point counts and caps (it
    is made anew for the larger ones) and over an insert with no valid
    point: its election grids all INT_MAX after each, every table equal to
    the twin's on a clone."""
    ms, *_ = _case(cuda, seed=3)
    rng = np.random.default_rng(3)
    scratch = vm.InsertScratch()
    for n, cap, frac in ((500, 64, 1.0), (4000, 0, 1.0), (9000, 2000, 0.9), (300, 0, 0.0)):
        pts = np.stack([rng.uniform(-6, 12, n), rng.uniform(-6, 6, n), rng.uniform(-3, 3, n)], -1)
        pts = torch.as_tensor(pts.astype(np.float32), device=cuda)
        val = torch.as_tensor(rng.uniform(size=n) < frac, device=cuda)
        a, c = _clone(ms), _clone(ms)
        ker, _ = vm.insert_points(a, T_CFG, pts, val, cap, True, scratch=scratch)
        ref, _ = vm.insert_points_plain(c, T_CFG, pts, val, cap, True)
        torch.cuda.synchronize()
        assert bool((scratch.grids == vm._INT_MAX).all()), n
        for name in vm.MapState._fields:
            assert torch.equal(getattr(ker, name), getattr(ref, name)), (n, name)
    assert scratch.P == 9000 and scratch.Pc == 4000


def test_active_set_kernels_match_plain(cuda):
    base, *_ = _case(cuda, seed=8)
    before = [t.clone() for t in base]
    bf16 = base._replace(embeddings=base.embeddings.to(torch.bfloat16))
    # the second truncates the set; the third packs bf16 embeddings
    for cfg, ms in ((T_CFG, base), (T_CFG._replace(active_cap=64), base), (T_CFG, bf16)):
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
    assert all(torch.equal(a, b) for a, b in zip(before, base))


@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("emb_dtype", [torch.float32, torch.bfloat16])
def test_reconcile_kernel_matches_plain(cuda, emb_dtype, mode):
    """K5, each call without a scratch and through one ReconcileScratch kept
    over calls with other touched sets, a truncating cap, an all-false mask
    and a grown map: every table equal to the twin's and between the two;
    the scratch's head table all -1 and its scan states zero after every
    call."""
    ms, *_ = _case(cuda, seed=9)
    ms = ms._replace(embeddings=ms.embeddings.to(emb_dtype))
    ms = ms._replace(packed=vm.pack_embeddings(ms, T_CFG))
    cfg0 = T_CFG._replace(active_cap=ms.packed.shape[0])  # the active set keeps its size on growth
    g = torch.Generator(device=cuda).manual_seed(9)
    A, n = ms.packed.shape[0], int(ms.n_active)
    live = torch.arange(A, device=cuda) < n
    touched = (torch.rand((A,), generator=g, device=cuda) < 0.5) & live
    other = (torch.rand((A,), generator=g, device=cuda) < 0.8) & live
    new_packed = ms.packed + 0.05 * torch.randn(ms.packed.shape, generator=g, device=cuda)
    scratch = vm.ReconcileScratch()
    big, big_cfg = vm.grow(ms, cfg0, 2 * cfg0.capacity)
    cases = ((ms, cfg0, touched, A), (ms, cfg0, touched, max(int(touched.sum()) // 3, 1)),
             (ms, cfg0, other, A), (ms, cfg0, torch.zeros_like(touched), A),
             (big, big_cfg, other, A))
    for st, cfg, mask, cap in cases:
        cpu = vm.MapState(*[x.cpu() for x in st])
        n0 = vm.reconcile_launches
        k1 = vm.reconcile(st, cfg, new_packed, mask, cap, mode=mode)
        k2 = vm.reconcile(st, cfg, new_packed, mask, cap, scratch=scratch, mode=mode)
        ref = vm.reconcile_plain(cpu, cfg, new_packed.cpu(), mask.cpu(), cap, mode)
        torch.cuda.synchronize()
        assert vm.reconcile_launches == n0 + 2
        for name in vm.Reconciled._fields:
            assert torch.equal(getattr(k1, name), getattr(k2, name)), (cap, name)
            assert torch.equal(getattr(k1, name).cpu(), getattr(ref, name)), (cap, name)
        assert torch.equal(k1.embeddings, st.embeddings) == (not bool(mask.any()))
        assert scratch.head.numel() == cfg.capacity and bool((scratch.head == -1).all())
        assert not bool(scratch.scan_state.any())


def test_pack_embeddings_kernels_match_plain(cuda):
    """E1: the forward (the pack pass) equal to pack_embeddings; the
    transpose through one PackGradScratch equal to the twin on the CPU and
    between two calls, over padding rows, twelve -1 corners (row 0's list
    longer than 8) and the thick wall's corners shared by 8 voxels; the
    scratch's head table all -1 after each build, and a grown map's
    build; PackEmbeddings' gradient on the card equal to the CPU's."""
    ms, *_ = _case(cuda, seed=10)
    A, n = ms.packed.shape[0], int(ms.n_active)
    cidx = ms.corner_idx.clone()
    rows = ms.active_ids[torch.arange(0, 12 * 7, 7, device=cuda)].long()
    cidx[rows, torch.arange(12, device=cuda) % 8] = -1
    ms = ms._replace(corner_idx=cidx)
    cpu = vm.MapState(*[x.cpu() for x in ms])
    used = torch.clamp(cidx[ms.active_ids[:n].long()], min=0).reshape(-1)
    counts = torch.bincount(used, minlength=T_CFG.capacity)
    assert n < A and int(counts[0]) > 8 and int((counts[1:] == 8).sum()) > 0
    g = torch.Generator(device=cuda).manual_seed(10)
    d = torch.randn((A, 128), generator=g, device=cuda) * torch.exp2(
        torch.randint(-12, 12, (A, 128), generator=g, device=cuda).float())
    d[n:] = 0.0
    n0, b0, f0 = vm.pack_grad_launches, vm.pack_grad_build_launches, vm.pack_embeddings_launches
    fwd = vm.pack_embeddings_fwd(ms, T_CFG, ms.embeddings)
    scratch = vm.PackGradScratch().build(ms, T_CFG)
    k1 = vm.pack_embeddings_vjp(d, scratch)
    k2 = vm.pack_embeddings_vjp(d, scratch)
    ref = vm.pack_embeddings_vjp_plain(d.cpu(), cpu.active_ids, cpu.corner_idx, cpu.n_active,
                                       T_CFG.capacity)
    torch.cuda.synchronize()
    assert (vm.pack_grad_launches - n0, vm.pack_grad_build_launches - b0,
            vm.pack_embeddings_launches - f0) == (2, 1, 1)
    assert torch.equal(fwd, vm.pack_embeddings(ms, T_CFG))
    assert torch.equal(k1, k2) and torch.equal(k1.cpu(), ref)
    head = scratch._bufs[0]
    assert bool((head == -1).all())
    big, big_cfg = vm.grow(ms, T_CFG._replace(active_cap=A), 2 * T_CFG.capacity)
    scratch.build(big, big_cfg)
    kb = vm.pack_embeddings_vjp(d, scratch)
    assert kb.shape == (big_cfg.capacity, 16) and torch.equal(kb[:T_CFG.capacity], k1)
    assert not bool(kb[T_CFG.capacity:].any()) and bool((scratch._bufs[0] == -1).all())
    # the autograd function on the card and on the CPU
    w = torch.randn((A, 128), generator=g, device=cuda)
    grads = []
    for st, dev in ((ms, cuda), (cpu, torch.device("cpu"))):
        e = st.embeddings.clone().requires_grad_(True)
        sc = vm.PackGradScratch().build(st, T_CFG)
        (vm.PackEmbeddings.apply(e, st, T_CFG, sc) * w.to(dev)).sum().backward()
        grads.append(e.grad)
    assert torch.equal(grads[0].cpu(), grads[1])


def test_divisions_and_adam_on_card_match_cpu(cuda):
    """The repaired divisions and the Adam step round on the card as on the
    CPU (where tests/test_torch_quality.py, test_torch_tracking.py and
    test_torch_adam.py hold them bit for bit to JAX and optax): a Python
    scalar over a tensor (``voxel_map.rdiv``: t_cap_for's band and the LM
    trust region's 0.5 / n and 0.1 / n) and band_sample_z at truncation
    0.3, one IEEE division each; and 400 Adam steps (two rounded products
    and an add per moment, tensor divisors, a sqrt rounded once). The norms
    around them are not held here: torch's CUDA vector norm rounds its sum
    of squares otherwise than its CPU one."""
    g = torch.Generator().manual_seed(5)
    x = torch.exp(torch.rand((1 << 16,), generator=g) * 24 - 12)
    for s_ in (0.3, 0.1, 0.5):
        assert torch.equal(vm.rdiv(s_, x.to(cuda)).cpu(), vm.rdiv(s_, x))
    c = torch.rand((4096,), generator=g)
    u = torch.rand((4096, 8), generator=g)
    d = torch.rand((4096,), generator=g) * 40.0
    assert torch.equal(trender.band_sample_z(d.to(cuda), c.to(cuda), 0.3, 8, u.to(cuda)).cpu(),
                       trender.band_sample_z(d, c, 0.3, 8, u))
    grads = torch.randn((400, 4096), generator=g) * torch.logspace(-8, 3, 4096)
    m_c, n_c = torch.zeros(4096, device=cuda), torch.zeros(4096, device=cuda)
    m, n = torch.zeros(4096), torch.zeros(4096)
    for t, gr in enumerate(grads, start=1):
        upd_c = ttr.scale_by_adam_(gr.to(cuda), m_c, n_c, t)
        upd = ttr.scale_by_adam_(gr, m, n, t)
        assert torch.equal(upd_c.cpu(), upd), f"step {t}"
    assert torch.equal(m_c.cpu(), m) and torch.equal(n_c.cpu(), n)


def test_norm3_and_divisions_on_card_match_cpu(cuda):
    """norm3 on the card (csrc/norm3.cu, one launch) is torch.equal to its
    plain form on the CPU (which tests/test_torch_ops.py holds bit for bit
    to jnp.linalg.norm) on 65,536 rows with magnitudes 1e-3 to 1e3 and
    zero rows, keepdim, batched, a (3,) vector and an empty input (no
    launch); it raises on what it cannot take. The routed divisions:
    exp_so3's series coefficients and interp_corner_features' / voxel_size
    give the CPU's digits."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn((1 << 16, 3), generator=g) * torch.exp(torch.rand((1 << 16, 1), generator=g)
                                                          * 13.8 - 6.9)
    x[::97] = 0.0
    before = ieee.norm3_launches
    assert torch.equal(ieee.norm3(x.to(cuda)).cpu(), ieee.norm3(x))
    assert torch.equal(ieee.norm3(x.to(cuda), keepdim=True).cpu(), ieee.norm3(x, keepdim=True))
    y = x[:65535].reshape(5, 13107, 3)
    assert torch.equal(ieee.norm3(y.to(cuda)).cpu(), ieee.norm3(y))
    assert torch.equal(ieee.norm3(x[5].to(cuda)).cpu(), ieee.norm3(x[5]))
    assert ieee.norm3(torch.zeros((0, 3), device=cuda)).shape == (0,)
    assert ieee.norm3_launches == before + 4
    assert torch.equal(ieee.norm3_plain(x.to(cuda)).cpu(), ieee.norm3(x))
    for bad in (x.to(cuda).double(), x.to(cuda)[:, :2], x.to(cuda).t(),
                x.to(cuda).requires_grad_(True)):
        with pytest.raises(ValueError):
            ieee.norm3(bad)
    t2 = torch.rand((8192,), generator=g) * 1e-8
    for got, ref in zip(tse3._sinc_coeffs(t2.to(cuda)), tse3._sinc_coeffs(t2)):
        assert torch.equal(got.cpu(), ref)
    for vs in (0.2, 0.3, 0.4):
        c = (torch.floor(torch.randn((4096, 3), generator=g) * 5) + 0.5) * vs
        p = c + (torch.rand((4096, 3), generator=g) - 0.5) * vs
        f = torch.randn((4096, 8, 16), generator=g)
        assert torch.equal(tinterp.interp_corner_features(p.to(cuda), c.to(cuda), f.to(cuda),
                                                          vs).cpu(),
                           tinterp.interp_corner_features(p, c, f, vs))
        assert torch.equal(ieee.div(p.to(cuda), vs).cpu(), ieee.div(p, vs))


def _lm_steps(n, seed):
    """n seeded (pose, solve solution) pairs: the first half at small angles
    (exp_so3's series branch), the rest at 0.8 rad rotations and 0.05 rad
    steps; translation steps of 1 mm to 1 m."""
    rng = np.random.default_rng(seed)
    small = (np.arange(n) < n // 2)[:, None]
    pose = np.concatenate([rng.normal(0, 10, (n, 3)), np.where(
        small, rng.normal(0, 3e-5, (n, 3)), rng.normal(0, 0.8, (n, 3)))], 1)
    step = np.concatenate([rng.normal(0, 0.3, (n, 3)) * np.exp(rng.uniform(-6, 1, (n, 1))),
                           np.where(small, rng.normal(0, 3e-5, (n, 3)),
                                    rng.normal(0, 0.05, (n, 3)))], 1)
    return torch.as_tensor(pose.astype(np.float32)), torch.as_tensor(step.astype(np.float32))


def test_lm_step_kernel_matches_plain(cuda):
    """lm_step (csrc/lm_step.cu, one launch for a batch, one thread a step)
    against lm_step_plain on 2,000 steps, on the card and one step a call on
    the CPU: pose and rotation matrix torch.equal (the sine, cosine and
    atan2 are glibc's on every side, native/trig.h; the 3x3 products XLA's
    fma chain, se3._matmul3), and its rotation matrix torch.equal to the
    twin's exp_so3 of the kernel's own pose on the card and the CPU; the
    one-step form (the tracker's) equal to the batch's row; it raises on
    what it cannot take."""
    P, S = _lm_steps(2000, 3)
    before = ttr.lm_step_launches
    kp, kR = ttr.lm_step(P.to(cuda), S.to(cuda))
    assert ttr.lm_step_launches == before + 1
    assert kp.shape == (2000, 6) and kR.shape == (2000, 3, 3)
    dp, dR = ttr.lm_step_plain(P.to(cuda), S.to(cuda))
    one = [ttr.lm_step_plain(P[i], S[i]) for i in range(0, 2000, 4)]
    cp, cR = torch.stack([x for x, _ in one]), torch.stack([r for _, r in one])
    for got, got_R, ref, ref_R in ((kp.cpu(), kR.cpu(), dp.cpu(), dR.cpu()),
                                   (kp[::4].cpu(), kR[::4].cpu(), cp, cR)):
        assert torch.equal(got, ref) and torch.equal(got_R, ref_R)
    assert torch.equal(kR.cpu(), tse3.pose_rotation(kp).cpu())
    assert torch.equal(kR.cpu(), tse3.pose_rotation(kp.cpu()))
    k1p, k1R = ttr.lm_step(P[9].to(cuda), S[9].to(cuda))
    assert torch.equal(k1p.cpu(), kp[9].cpu()) and torch.equal(k1R.cpu(), kR[9].cpu())
    for bad in ((P.to(cuda).double(), S.to(cuda).double()), (P.to(cuda)[:, :5], S.to(cuda)[:, :5]),
                (P.to(cuda), S.to(cuda)[:1000]), (P.to(cuda).t(), S.to(cuda).t())):
        with pytest.raises(ValueError):
            ttr.lm_step(*bad)


@pytest.mark.parametrize("trunc", [0.3, 0.5])
def test_ray_prep_kernel_matches_plain(cuda, trunc):
    """ray_prep (csrc/ray_prep.cu, one launch) torch.equal to ray_prep_plain
    on the card and on the CPU for every output, at a tracker's 2048 rays
    of magnitudes 1e-2 to 1e2 with zero rows and cosines below 0.05, and in
    BA's (W, K, 3) form; no launch for no ray; it raises on what it cannot
    take."""
    rng = np.random.default_rng(4)
    pts = (rng.standard_normal((2048, 3)) * 10 ** rng.uniform(-2, 2, (2048, 1))).astype(np.float32)
    pts[::97] = 0.0
    c = rng.uniform(-0.2, 1.0, 2048).astype(np.float32)
    for p_, c_ in ((pts, c), (pts.reshape(2, 1024, 3), c.reshape(2, 1024))):
        p_, c_ = torch.as_tensor(p_), torch.as_tensor(c_)
        before = ttr.ray_prep_launches
        ker = ttr.ray_prep(p_.to(cuda), c_.to(cuda), trunc, 60.0)
        assert ttr.ray_prep_launches == before + 1
        dev = ttr.ray_prep_plain(p_.to(cuda), c_.to(cuda), trunc, 60.0)
        cpu = ttr.ray_prep_plain(p_, c_, trunc, 60.0)
        for k, d, h in zip(ker, dev, cpu):
            assert k.shape == h.shape and torch.equal(k.cpu(), d.cpu()) and torch.equal(k.cpu(), h)
    empty = ttr.ray_prep(torch.zeros((0, 3), device=cuda), torch.zeros((0,), device=cuda), trunc,
                         60.0)
    assert empty.dirs.shape == (0, 3) and empty.depth_ok.shape == (0,)
    pc, cc = torch.as_tensor(pts).to(cuda), torch.as_tensor(c).to(cuda)
    for bad in ((pc.double(), cc), (pc[:, :2].contiguous(), cc), (pc, cc[:100]),
                (pc.t().contiguous().t(), cc)):
        with pytest.raises(ValueError):
            ttr.ray_prep(*bad, trunc, 60.0)


def test_mesh_lattice_rejects_what_it_would_convert():
    """K10a's wrapper takes its inputs as they are, on the CPU too: int64 or
    strided voxel ids, a strided or int64 table, embeddings of another type
    or width raise ValueError instead of being converted; what it takes,
    the CPU twin computes."""
    ms, *_ = _case("cpu", seed=11)
    ids = vm.surface_voxel_ids(ms)
    assert ids.dtype == torch.int32 and ids.numel() > 8
    feats, pos = tmesher.mesh_lattice(ms, T_CFG, ids, 2)
    rf, rp = tmesher.mesh_lattice_plain(ms, T_CFG, ids, 2)
    assert torch.equal(feats, rf) and torch.equal(pos, rp)
    wide = torch.zeros((ms.embeddings.shape[0], 32))
    for voxel_ids, state, match in (
            (ids.long(), ms, "voxel_ids must be a contiguous torch.int32"),
            (ids[::2], ms, "voxel_ids must be a contiguous"),
            (ids[None], ms, r"voxel_ids must be \(B,\)"),
            (ids, ms._replace(corner_idx=ms.corner_idx.t().contiguous().t()),
             "corner_idx must be a contiguous"),
            (ids, ms._replace(lat_coords=ms.lat_coords.long()), "lat_coords must be a contiguous"),
            (ids, ms._replace(embeddings=ms.embeddings.half()), "float32 or bfloat16"),
            (ids, ms._replace(embeddings=wide[:, ::2]), "embeddings must be a contiguous"),
            (ids, ms._replace(embeddings=wide), "embeddings has shape")):
        with pytest.raises(ValueError, match=match):
            tmesher.mesh_lattice(state, T_CFG, voxel_ids, 2)


def test_pack_embeddings_wrappers_reject_what_they_cannot_read():
    """E1's wrappers raise on a scratch never built, and the forward on a
    device it does not know; they run everywhere."""
    ms, *_ = _case("cpu", seed=10)
    with pytest.raises(ValueError, match="not been built"):
        vm.pack_embeddings_vjp(torch.zeros_like(ms.packed), vm.PackGradScratch())
    with pytest.raises(ValueError, match="unsupported device"):
        vm.pack_embeddings_fwd(ms, T_CFG, ms.embeddings.to("meta"))
    scratch = vm.PackGradScratch().build(ms, T_CFG)
    assert scratch._bufs is None  # the CPU twin needs no buffers
    d = torch.zeros_like(ms.packed)
    assert not bool(vm.pack_embeddings_vjp(d, scratch).any())


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


def _device_launches(fn, reps=10, sessions=5):
    """{device operation: launches per call of fn} from torch.profiler over
    ``reps`` calls after a discarded warm-up step of as many (a cold
    session drops records); a session whose counts are not whole
    multiples of ``reps`` (a dropped or stray record) is run again."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    counts = {}
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        counts = {e.key: e.count for e in prof.key_averages()
                  if getattr(e, "self_device_time_total", 0.0) > 0}
        if counts and not any(n % reps for n in counts.values()):
            return {k: n // reps for k, n in counts.items()}
    raise AssertionError(f"the profiler kept {counts} device records of {reps} calls")


@pytest.mark.parametrize("origin", ["per ray", "row stride 0"])
@pytest.mark.parametrize("S", [45, 75, 100, 200])
def test_placer_march_is_one_launch_and_matches_plain(cuda, origin, S):
    """K9a launched as part of making a placer (CdfPlacer.march) and through
    march_occupancy: cdf and n_occ equal to the twin's, one CUDA launch a
    march and nothing else (the trackers' expanded origin read as it is,
    not copied), at widths of one to two groups of four rounds."""
    ms, o, d, tc = _case(cuda, seed=16)
    rc = T_RC._replace(sampler="grid", n_samples=32, n_coarse=S, coarse_step=12.0 / S)
    ro = o if origin == "per ray" else o[:1].expand_as(d)
    pcdf, pn = trc.march_occupancy_plain(ms, T_CFG, rc, ro, d, tc)
    n0 = trc.march_occupancy_launches
    placer = trc.CdfPlacer.march(ms, T_CFG, rc, ro, d, tc, 32)
    cdf, n_occ = trc.march_occupancy(ms, T_CFG, rc, ro, d, tc)
    torch.cuda.synchronize()
    assert trc.march_occupancy_launches == n0 + 2
    assert placer.cdf.shape == (o.shape[0], S)
    for got in ((placer.cdf, placer.n_occ), (cdf, n_occ)):
        assert torch.equal(got[0], pcdf) and torch.equal(got[1], pn)
    assert 0.3 < float((pn > 0).float().mean()) <= 1.0
    g = torch.Generator(device=cuda).manual_seed(S)
    u = trc.uniform_jitter((o.shape[0], 32), g, cuda)
    ker = placer(ro, d, u)
    ref = trc.place_samples_cdf_plain(ms, T_CFG, rc, pcdf, pn, ro, d, tc, u)
    torch.cuda.synchronize()
    for i, name in ((1, "aid"), (2, "valid"), (3, "ray_mask")):
        assert torch.equal(ker[i], ref[i]), name
    for fn in (lambda: trc.CdfPlacer.march(ms, T_CFG, rc, ro, d, tc, 32),
               lambda: trc.march_occupancy(ms, T_CFG, rc, ro, d, tc)):
        ops = _device_launches(fn)
        assert len(ops) == 1 and "march_occupancy_kernel" in next(iter(ops)), ops
        assert next(iter(ops.values())) == 1, ops


@pytest.mark.parametrize("S, M", [(45, 37), (100, 64), (75, 32)])
def test_place_samples_kernel_shared_origin_matches_plain(cuda, S, M):
    """K9b with one origin for every ray (row stride 0, as the trackers pass
    it), at cdf widths and sample counts that are not multiples of 32."""
    ms, o, d, tc = _case(cuda, seed=12)
    rc = T_RC._replace(sampler="grid", n_samples=M, n_coarse=S, coarse_step=12.0 / S)
    cdf, n_occ = trc.march_occupancy(ms, T_CFG, rc, o[:1].expand_as(d), d, tc)
    assert cdf.shape == (o.shape[0], S)
    g = torch.Generator(device=cuda).manual_seed(S)
    o2 = (o[0] + 0.02).expand_as(d)
    assert o2.stride(0) == 0
    placer = trc.CdfPlacer(ms, T_CFG, rc, cdf, n_occ, tc, M)  # a tracker's, once per frame
    n0 = trc.place_samples_cdf_launches
    for _ in range(2):  # each call refills the placer's buffers
        u = trc.uniform_jitter((o.shape[0], M), g, cuda)
        ker = placer(o2, d, u)
        ref = trc.place_samples_cdf_plain(ms, T_CFG, rc, cdf, n_occ, o2, d, tc, u)
        torch.cuda.synchronize()
        for i, name in ((1, "aid"), (2, "valid"), (3, "ray_mask")):
            assert torch.equal(ker[i], ref[i]), name
        ulp = torch.nextafter(ref[0], torch.full_like(ref[0], float("inf"))) - ref[0]
        assert bool(((ker[0] - ref[0]).abs() <= ulp).all())
        assert 0.1 < float(ref[2].float().mean()) < 1.0
    assert trc.place_samples_cdf_launches == n0 + 2
    out = (ctypes.c_int * 32)()
    layout = list(out[:kernels.lib().nl_place_args_layout(out)])
    assert layout == [ctypes.sizeof(trc._PlaceArgs)] + [getattr(trc._PlaceArgs, f).offset
                                                         for f, _ in trc._PlaceArgs._fields_]
    wide = torch.zeros((o.shape[0], kernels.lib().nl_place_max_slots() + 1), device=cuda)
    with pytest.raises(ValueError, match="coarse slots"):
        trc.place_samples_cdf(ms, T_CFG, rc, wide, n_occ, o2, d, tc, u)


def test_place_samples_kernel_superset_rows_match_plain(cuda):
    """K9b in BA's form: a placer over a superset cdf, each call's rays
    reading their rows through ``rows`` (a row outside the cdf reads
    nothing: its ray misses), against the twin on the gathered rows."""
    ms, o, d, tc = _case(cuda, seed=13)
    rc = T_RC._replace(sampler="grid", n_samples=40)
    cdf, n_occ = trc.march_occupancy(ms, T_CFG, rc, o, d, tc)
    C = o.shape[0]
    g = torch.Generator(device=cuda).manual_seed(13)
    rows = torch.randint(0, C, (C // 2,), generator=g, device=cuda, dtype=torch.int32)
    R = rows.shape[0]
    placer = trc.CdfPlacer(ms, T_CFG, rc, cdf, n_occ, tc, 40, R)
    idx = rows.long()
    o2, d2 = (o[idx] + 0.02).contiguous(), d[idx].contiguous()
    u = trc.uniform_jitter((R, 40), g, cuda)
    n0 = trc.place_samples_cdf_launches
    ker = [t.clone() for t in placer(o2, d2, u, rows)]
    ref = trc.place_samples_cdf_plain(ms, T_CFG, rc, cdf[idx], n_occ[idx], o2, d2, tc[idx], u)
    torch.cuda.synchronize()
    assert trc.place_samples_cdf_launches == n0 + 1
    for i, name in ((1, "aid"), (2, "valid"), (3, "ray_mask")):
        assert torch.equal(ker[i], ref[i]), name
    ulp = torch.nextafter(ref[0], torch.full_like(ref[0], float("inf"))) - ref[0]
    assert bool(((ker[0] - ref[0]).abs() <= ulp).all())
    assert 0.1 < float(ref[2].float().mean()) < 1.0
    off = rows.clone()
    off[:3] = torch.tensor([-1, C, 1 << 30], dtype=torch.int32, device=cuda)
    z, aid, valid, ray_mask = placer(o2, d2, u, off)
    torch.cuda.synchronize()
    assert not bool(ray_mask[:3].any()) and not bool(valid[:3].any())
    assert bool((aid[:3] == -1).all()) and bool((z[:3] == 0).all())
    assert torch.equal(valid[3:], ref[2][3:])


def test_render_rays_grid_autograd_on_card_matches_cpu(cuda):
    ms, o, d, tc = _case(cuda, seed=11)
    rc = T_RC._replace(sampler="grid", n_samples=24)
    cdf, n_occ = trc.march_occupancy_plain(ms, T_CFG, rc, o, d, tc)
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
        placer = trc.CdfPlacer(st, T_CFG, rc, cdf.to(dev), n_occ.to(dev), tc.to(dev), 24)
        field = trender.ActiveField(st, T_CFG)
        out = trender.render_rays(packed, {k: [w.to(dev) for w in v] for k, v in params.items()},
                                  field, oo, dd, rv.to(dev), placer, u.to(dev),
                                  extra=(field, ez.to(dev), rv.to(dev)))
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
    # B = 0: empty outputs, no launch
    ef, ep = tmesher.mesh_lattice(ms, T_CFG, ids[:0], res)
    assert ef.shape == (0, res ** 3, 16) and ep.shape == (0, res ** 3, 3)
    assert tmesher.mesh_lattice_launches == n0[0]
    kf, kp = tmesher.mesh_lattice(ms, T_CFG, ids, res)
    rf, rp = tmesher.mesh_lattice_plain(ms, T_CFG, ids, res)
    assert kf.shape == (ids.numel(), res ** 3, 16) and kp.shape == (ids.numel(), res ** 3, 3)
    assert torch.equal(kf, rf) and torch.equal(kp, rp)
    # a chunk that ends inside a block (voxels of a block past B are skipped)
    kf7, kp7 = tmesher.mesh_lattice(ms, T_CFG, ids[:7], res)
    assert torch.equal(kf7, rf[:7]) and torch.equal(kp7, rp[:7])
    if res == 2:  # weights 0 / 1: the corner rows themselves
        rows = ms.embeddings[ms.corner_idx[ids.clamp(min=0).long()].clamp(min=0).long()].float()
        assert torch.equal(kf, rows)
    g = torch.Generator(device=cuda).manual_seed(res)
    sdf = rf @ torch.randn((16,), generator=g, device=cuda) + 0.05
    cct = torch.as_tensor(tmesher._cell_corner_table(res), device=cuda)
    kt, kv = tmarch.marching_tets_lattice(sdf, rp, cct, ids)
    rt, rv = tmarch.marching_tets_lattice_plain(sdf, rp, cct, ids)
    torch.cuda.synchronize()
    assert (tmesher.mesh_lattice_launches, tmarch.marching_tets_launches) == (n0[0] + 2,
                                                                              n0[1] + 1)
    assert kt.shape == (ids.numel() * (res - 1) ** 3, 12, 3, 3)
    assert torch.equal(kv, rv) and torch.equal(kt, rt)
    assert bool(rv.any()) and not bool(rv[-37 * (res - 1) ** 3:].any())


def _tets_chunk(device, case, seed=0):
    """A chunk of B voxels' res-2 lattices (one cell each): random sdf
    around 0 (about half the tets cut) and positions; ``case`` "empty":
    every sdf positive (T = 0); "many blocks": 9,000 voxels (141 tiles of
    64 cells); "empty runs": 9,000 voxels in runs of 7 tiles without a
    triangle between runs of 3 with; "padding": every third id -1 and a
    padded tail."""
    g = torch.Generator(device=device).manual_seed(seed)
    B = 300 if case == "empty" else 9000
    sdf = torch.randn((B, 8), generator=g, device=device) * 0.2 + 0.05
    pos = torch.rand((B, 1, 3), generator=g, device=device) * 20.0 + torch.rand(
        (B, 8, 3), generator=g, device=device) * 0.2
    ids = torch.arange(B, dtype=torch.int32, device=device)
    if case == "empty":
        sdf = sdf.abs() + 0.01
    elif case == "empty runs":
        tile = torch.arange(B, device=device) // 64
        sdf[tile % 10 < 7] = sdf[tile % 10 < 7].abs() + 0.01
    elif case == "padding":
        ids[::3] = -1
        ids[-100:] = -1
    cct = torch.as_tensor(tmesher._cell_corner_table(2), device=device)
    return sdf.contiguous(), pos.contiguous(), cct, ids


@pytest.mark.parametrize("case", ["empty", "many blocks", "empty runs", "padding"])
def test_marching_tets_compact_kernel_matches_twin(cuda, case):
    """K10b's compact form against the padded twin's ``tris[valid]``: T and
    the triangles equal, two calls in a row through one TetScratch equal
    (its tile states and tickets left all zero after each call), a
    scratch made for the call too, one CUDA launch a call."""
    sdf, pos, cct, ids = _tets_chunk(cuda, case)
    rt, rv = tmarch.marching_tets_lattice_plain(sdf, pos, cct, ids)
    want = rt[rv]
    scratch = tmarch.TetScratch()
    n0 = tmarch.marching_tets_launches
    outs = [tmarch.marching_tets_compact(sdf, pos, cct, ids, scratch=scratch) for _ in range(2)]
    outs.append(tmarch.marching_tets_compact(sdf, pos, cct, ids))
    torch.cuda.synchronize()
    assert tmarch.marching_tets_launches == n0 + 3
    assert not bool(scratch.state.any())
    assert scratch.tiles == (sdf.shape[0] + 63) // 64
    for tris, T in outs:
        assert tris.shape == (sdf.shape[0] * 12, 3, 3) and T.dtype == torch.int32
        assert int(T) == want.shape[0]
        assert torch.equal(tris[:int(T)], want)
    if case == "empty":
        assert want.shape[0] == 0
    else:
        assert want.shape[0] > 2000
    kt, kv = tmarch.marching_tets_lattice(sdf, pos, cct, ids)
    assert torch.equal(kt[kv], want)
    ops = _device_launches(lambda: tmarch.marching_tets_compact(sdf, pos, cct, ids,
                                                                scratch=scratch))
    assert len(ops) == 1 and "marching_tets_kernel" in next(iter(ops)), ops
    assert next(iter(ops.values())) == 1, ops


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
    # the port's launches a call: one cooperative kernel (at most two)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(5):
            ts2s.build_prev_scan(sp, pts, valid, pose)
        torch.cuda.synchronize()
    port = sum(e.count for e in prof.key_averages() if "s2s_range_image_kernel" in e.key)
    assert 0 < port <= 2 * 5


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


def test_s2s_system_kernel_accumulates_like_plain(cuda):
    """The tracker's form: the rotation given and K3's sums taken in place."""
    pts, valid = _scan(cuda, seed=1)
    prev = ts2s.build_prev_scan(S2S, pts, valid,
                                torch.tensor([0.1, 0.0, 0.0, 0.0, 0.0, 0.01], device=cuda))
    cur, _ = _scan(cuda, n=6000, seed=3)
    pose = torch.tensor([0.4, 0.1, 0.02, 0.0, 0.01, 0.02], device=cuda)
    cur = (cur[:2048] - pose[:3]).contiguous()
    rv = torch.rand(len(cur), device=cuda) > 0.05
    R = tse3.pose_rotation(pose)
    g = torch.Generator(device=cuda).manual_seed(3)
    acc0 = (torch.randn((6, 6), generator=g, device=cuda) * 100.0,
            torch.randn((6,), generator=g, device=cuda) * 10.0, torch.tensor(5.0, device=cuda))
    n0 = ts2s.s2s_system_launches
    k1, k2 = (ts2s.s2s_system(S2S, prev, pose, cur, rv, R, tuple(a.clone() for a in acc0))
              for _ in range(2))
    ref = ts2s.s2s_system_plain(S2S, prev, pose, cur, rv, R, tuple(a.clone() for a in acc0))
    alone = ts2s.s2s_system(S2S, prev, pose, cur, rv, R)
    torch.cuda.synchronize()
    assert ts2s.s2s_system_launches == n0 + 3
    assert float(torch.trace(alone[0][:3, :3])) > 1000
    for name, a, b, r, x, y in zip(("H", "b", "loss"), k1, k2, ref, acc0, alone):
        assert torch.equal(a, b), f"{name} differs between two runs"
        assert float((a - r).abs().max()) <= 1e-5 * float(r.abs().max()), name
        assert torch.equal(a, x + y), f"{name} is not one add on the sums alone"
    # as the tracker calls it: into a GnSystem's own outputs, in place
    tp = ttr.TrackParams(n_rays=512, num_iterations=1, truncation=0.3, max_depth=40.0,
                         fs_weight=1.0, sdf_weight=1e4)
    gi = _gn_inputs(cuda, N=512, MK=72, seed=3)
    system = ttr.GnSystem(gi["pcos"], gi["d_meas"], gi["depth_ok"], gi["bias_ray"], tp, 72)
    samples = [gi[k] for k in ("xyz", "t_pos", "z", "sdf", "g", "vmask")]
    k3 = [x.clone() for x in system(*samples)]
    out = system(*samples)
    added = ts2s.s2s_system(S2S, prev, pose, cur, rv, R, out)
    plain = ts2s.s2s_system_plain(S2S, prev, pose, cur, rv, R, tuple(x.clone() for x in k3))
    torch.cuda.synchronize()
    for name, a, r, x, y in zip(("H", "b", "loss"), added, plain, k3, alone):
        assert a is not None and a.data_ptr() == out[("H", "b", "loss").index(name)].data_ptr()
        assert float((a - r).abs().max()) <= 1e-5 * float(r.abs().max()), name
        assert torch.equal(a, x + y), f"{name} is not one add on K3's sums"


def test_grid_and_s2s_wrappers_reject_what_they_would_convert(cuda):
    """K9b and K11b take their inputs as they are: a CPU or meta tensor among
    CUDA ones, or a wrong dtype, raises instead of being moved or cast."""
    ms, o, d, tc = _case(cuda, seed=13)
    rc = T_RC._replace(sampler="grid", n_samples=32)
    cdf, n_occ = trc.march_occupancy(ms, T_CFG, rc, o, d, tc)
    u = torch.rand((len(o), 32), device=cuda)
    ok = dict(cdf=cdf, n_occ=n_occ, rays_o=o, rays_d=d, t_cap=tc, u=u)
    for key, value in (("cdf", cdf.cpu()), ("u", u.to("meta")), ("t_cap", tc.double()),
                       ("rays_d", d.half())):
        with pytest.raises(ValueError, match=f"{key} must be a contiguous"):
            trc.place_samples_cdf(ms, T_CFG, rc, **{**ok, key: value})
    with pytest.raises(ValueError, match="grid_active must be a contiguous"):
        trc.place_samples_cdf(ms._replace(grid_active=ms.grid_active.cpu()), T_CFG, rc, **ok)
    pts, valid = _scan(cuda, seed=1)
    prev = ts2s.build_prev_scan(S2S, pts, valid, torch.zeros(6, device=cuda))
    cur, rv, pose = pts[:512].contiguous(), valid[:512].contiguous(), torch.zeros(6, device=cuda)
    for args, match in (((pose.cpu(), cur, rv), "pose6 must"), ((pose, cur, rv.to("meta")),
                                                                 "rvalid must"),
                        ((pose, cur.double(), rv), "pts must")):
        with pytest.raises(ValueError, match=match):
            ts2s.s2s_system(S2S, prev, *args)
    with pytest.raises(ValueError, match="q_w must"):
        ts2s.s2s_system(S2S, prev._replace(q_w=prev.q_w.cpu()), pose, cur, rv)
    acc = (torch.zeros((6, 6), device=cuda), torch.zeros(6, device=cuda), torch.zeros(()))
    with pytest.raises(ValueError, match="loss must"):
        ts2s.s2s_system(S2S, prev, pose, cur, rv, acc=acc)
    _reject_gn_and_field_conversions(cuda)


def _reject_gn_and_field_conversions(device):
    """GnSystem (K3) and ActiveField (K8) raise on what they would have to
    convert: another device, another dtype, a strided tensor or a shape
    other than the one they were made for."""
    tp = ttr.TrackParams(n_rays=64, num_iterations=1, truncation=0.3, max_depth=40.0,
                         fs_weight=1.0, sdf_weight=1e4)
    a = _gn_inputs(device, N=64, MK=9, seed=2)
    with pytest.raises(ValueError, match="d_meas must be a contiguous"):
        ttr.GnSystem(a["pcos"], a["d_meas"].double(), a["depth_ok"], a["bias_ray"], tp, 9)
    with pytest.raises(ValueError, match="depth_ok must be a contiguous"):
        ttr.GnSystem(a["pcos"], a["d_meas"], a["depth_ok"].int(), a["bias_ray"], tp, 9)
    system = ttr.GnSystem(a["pcos"], a["d_meas"], a["depth_ok"], a["bias_ray"], tp, 9)
    good = {k: a[k] for k in ("xyz", "t_pos", "z", "sdf", "g", "vmask")}
    other = "meta" if device.type == "cpu" else "cpu"
    for key, value, match in (("xyz", a["xyz"].to(other), "xyz must be a contiguous"),
                              ("z", a["z"].double(), "z must be a contiguous"),
                              ("sdf", a["sdf"].t().contiguous().t(), "sdf must be a contiguous"),
                              ("vmask", a["vmask"].float(), "vmask must be a contiguous"),
                              ("g", a["g"][:, :8].contiguous(), "g has shape"),
                              ("t_pos", a["t_pos"].half(), "t_pos must be a contiguous")):
        with pytest.raises(ValueError, match=match):
            system(**{**good, key: value})
    ms, o, d, tc = _case(device, R=32, seed=4)
    z = torch.rand((32, 4), device=device) * 10.0
    rv = torch.ones((32,), dtype=torch.bool, device=device)
    with pytest.raises(ValueError, match="grid_active must be a contiguous"):
        trender.ActiveField(ms._replace(grid_active=ms.grid_active.long()), T_CFG)
    with pytest.raises(ValueError, match="region_min must be a contiguous"):
        trender.ActiveField(ms._replace(region_min=ms.region_min.to(other)), T_CFG)
    field = trender.ActiveField(ms, T_CFG)
    good = dict(packed=ms.packed, rays_o=o, rays_d=d, z=z, ray_valid=rv)
    for key, value, match in (("z", z.double(), "z must be a contiguous"),
                              ("z", z.t().contiguous().t(), "z must be a contiguous"),
                              ("ray_valid", rv.to(other), "ray_valid must be a contiguous"),
                              ("rays_d", d.to(other), "rays_d must be a contiguous"),
                              ("rays_o", torch.cat([o, o], 1)[:, :3], "rays_o must be"),
                              ("rays_o", o.double(), "rays_o must be"),
                              ("packed", ms.packed.reshape(-1, 64), "packed has shape"),
                              ("packed", ms.packed.reshape(-1)[1:129].reshape(1, 128),
                               "16-byte boundary")):
        with pytest.raises(ValueError, match=match):
            field(**{**good, key: value})
    with pytest.raises(ValueError, match="xyz must be a contiguous"):
        field(ms.packed, None, None, z, rv, torch.zeros((32, 4, 3), device=device).double())
    with pytest.raises(ValueError, match="rays_o = rays_d = None"):
        field(ms.packed, o, d, z, rv, torch.zeros((32, 4, 3), device=device))


def test_gn_and_field_wrappers_reject_what_they_would_convert_on_cpu():
    _reject_gn_and_field_conversions(torch.device("cpu"))


def test_hits_field_wrappers_reject_what_they_would_convert(cuda):
    """K4, K1, K2 and K5 take their inputs as they are: a CPU tensor among
    CUDA ones, another dtype or a strided tensor raises instead of being
    moved, cast or copied."""
    ms, o, d, tc = _case(cuda, seed=14)
    ht = trc.build_hit_table(ms, T_CFG, T_RC, o, d, tc)
    u = torch.rand((len(o), 8), device=cuda)
    ok = dict(ht=ht, u=u, rays_o=o, rays_d=d, packed=ms.packed)
    for key, value, match in (("u", u.cpu(), "u must be a contiguous"),
                              ("rays_d", d.double(), "rays_d must be a contiguous"),
                              ("ht", ht._replace(aid=ht.aid.long()), "aid must be a contiguous"),
                              ("ht", ht._replace(seg=ht.seg.cpu()), "seg must be"),
                              ("rays_o", o.t().contiguous().t(), "rays_o must be")):
        with pytest.raises(ValueError, match=match):
            trender.hits_field_fwd(**{**ok, key: value}, voxel_size=VS)
    _, valid, aid, xyz, feats = trender.hits_field_fwd(ht, u, o, d, ms.packed, VS)
    good = (torch.randn_like(feats), xyz, aid, valid, ms.packed)
    for i, value, match in ((0, good[0].cpu(), "dfeats must be a contiguous"),
                            (1, xyz.transpose(0, 1).contiguous().transpose(0, 1),
                             "xyz must be a contiguous"),
                            (2, aid.long(), "aid must be a contiguous"),
                            (4, ms.packed.double(), "packed must be a contiguous")):
        args = list(good)
        args[i] = value
        with pytest.raises(ValueError, match=match):
            trender.hits_field_bwd(*args, VS)
    good = dict(rays_o=o, rays_d=d, t_cap=tc)
    for key, value, match in (("rays_d", d.double(), "rays_d must be a contiguous"),
                              ("rays_d", d.t().contiguous().t(), "rays_d must be a contiguous"),
                              ("t_cap", tc.cpu(), "t_cap must be a contiguous"),
                              ("t_cap", tc[:-1], "t_cap has shape"),
                              ("rays_o", torch.cat([o, o], 1)[:, :3], "rays_o must be"),
                              ("rays_o", o.double(), "rays_o must be")):
        for build in (trc.build_hit_table, trc.build_hit_table_packed):
            with pytest.raises(ValueError, match=match):
                build(ms, T_CFG, T_RC, **{**good, key: value})
    with pytest.raises(ValueError, match="grid_active must be a contiguous"):
        trc.build_hit_table(ms._replace(grid_active=ms.grid_active.long()), T_CFG, T_RC, o, d, tc)
    with pytest.raises(ValueError, match="max_hits 65 outside"):
        trc.build_hit_table(ms, T_CFG, T_RC._replace(max_hits=65), o, d, tc)
    A = ms.packed.shape[0]
    touched = torch.zeros((A,), dtype=torch.bool, device=cuda)
    for st, new, mask, match in (
            (ms, ms.packed, touched.to(torch.uint8), "touched must be a contiguous"),
            (ms, ms.packed.double(), touched, "new_packed must be a contiguous"),
            (ms, ms.packed.t().contiguous().t(), touched, "new_packed must be a contiguous"),
            (ms._replace(active_ids=ms.active_ids.long()), ms.packed, touched,
             "active_ids must be a contiguous"),
            (ms._replace(embeddings=ms.embeddings.half()), ms.packed, touched,
             "embeddings must be float32 or bfloat16"),
            (ms._replace(upd_count=ms.upd_count.cpu()), ms.packed, touched,
             "upd_count must be a contiguous")):
        with pytest.raises(ValueError, match=match):
            vm.reconcile(st, T_CFG, new, mask, A)


def test_insert_and_range_image_reject_what_they_would_convert(cuda):
    """K7 and K11a take their inputs as they are: another dtype, a strided
    tensor, a CPU tensor among CUDA ones or a 0-d scalar of another type
    raises instead of being cast or copied (K7 writes the state in place,
    so nothing may be a converted copy); nothing is written before."""
    ms, *_ = _case(cuda, seed=15)
    pts = torch.rand((400, 3), device=cuda) * 8.0
    val = torch.ones(400, dtype=torch.bool, device=cuda)
    before = _clone(ms)
    for st, p, v, match in (
            (ms, pts.double(), val, "points_world must be a contiguous"),
            (ms, pts.t().contiguous().t(), val, "points_world must be a contiguous"),
            (ms, pts, val.to(torch.uint8), "valid must be a contiguous"),
            (ms, pts, val.cpu(), "valid must be a contiguous"),
            (ms._replace(num_lat=ms.num_lat.long()), pts, val, "num_lat must be a contiguous"),
            (ms._replace(grid=ms.grid.cpu()), pts, val, "grid must be a contiguous"),
            (ms._replace(embeddings=ms.embeddings.half()), pts, val, "embeddings must be")):
        with pytest.raises(ValueError, match=match):
            vm.insert_points(st, T_CFG, p, v, 0, True)
    assert all(torch.equal(x, y) for x, y in zip(ms, before))
    scan, valid = _scan(cuda, n=600)
    pose = torch.zeros(6, device=cuda)
    for p, v, q, match in ((scan.double(), valid, pose, "points must be a contiguous"),
                           (scan, valid.to(torch.uint8), pose, "valid must be a contiguous"),
                           (scan, valid, pose.double(), "pose6 must be a contiguous"),
                           (scan, valid, pose.cpu(), "pose6 must be a contiguous"),
                           (scan, valid[:-1], pose, "valid has shape")):
        with pytest.raises(ValueError, match=match):
            ts2s.build_prev_scan(S2S, p, v, q)


def test_wrappers_reject_other_devices():
    ms, o, d, tc = _case("cpu")
    meta = [x.to("meta") for x in (o, d, tc)]
    with pytest.raises(ValueError, match="unsupported device"):
        trc.build_hit_table(ms, T_CFG, T_RC, *meta)
    ht = trc.build_hit_table(ms, T_CFG, T_RC, o, d, tc)
    with pytest.raises(ValueError, match="unsupported device"):
        trender.hits_field_fwd(ht, torch.zeros(o.shape[0], 4), o, d, ms.packed.to("meta"), 0.5)
    z, valid, aid, xyz, feats = trender.hits_field_fwd(ht, torch.zeros(o.shape[0], 4), o, d,
                                                       ms.packed, 0.5)
    with pytest.raises(ValueError, match="unsupported device"):
        trender.hits_field_bwd(feats, xyz, aid, valid, ms.packed.to("meta"), 0.5)
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
    with pytest.raises(ValueError, match="unsupported device"):
        tmarch.marching_tets_compact(torch.zeros(4, 8, device="meta"),
                                     torch.zeros(4, 8, 3, device="meta"),
                                     torch.zeros(1, 8, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        trc.CdfPlacer.march(ms, T_CFG, T_RC, *meta, 8)
    pts, valid = _scan("cpu", n=600)
    with pytest.raises(ValueError, match="unsupported device"):
        ts2s.build_prev_scan(S2S, pts.to("meta"), valid.to("meta"), torch.zeros(6, device="meta"))
    prev = ts2s.build_prev_scan(S2S, pts, valid, torch.zeros(6))
    with pytest.raises(ValueError, match="unsupported device"):
        ts2s.s2s_system(S2S, prev, torch.zeros(6), pts.to("meta"), valid.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ttr.lm_step(torch.zeros(6, device="meta"), torch.zeros(6, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ttr.ray_prep(pts.to("meta"), torch.ones(len(pts), device="meta"), 0.3, 60.0)


def test_kernel_library_is_built_lazily():
    # importing the port builds nothing; one library per source, its name
    # carrying a hash of that source
    srcs = kernels.sources()
    assert {os.path.basename(s) for s in srcs} >= {
        "hit_table.cu", "hits_field.cu", "active_field.cu", "gn_system.cu", "insert.cu",
        "active_set.cu", "reconcile.cu", "grid_sampler.cu", "mesh.cu", "scan2scan.cu",
        "pack_grad.cu", "norm3.cu", "lm_step.cu", "ray_prep.cu"}
    paths = [kernels.library_path(s) for s in srcs]
    assert len(set(paths)) == len(srcs)
    for path in paths:
        assert os.path.dirname(path) == kernels.BUILD_DIR
        assert len(os.path.basename(path).split("_")[-1]) == len("0123456789abcdef.so")
    assert kernels._lib is None or torch.cuda.is_available()
    assert "-fmad=false" in kernels.NVCC_FLAGS and "--use_fast_math" not in kernels.NVCC_FLAGS
