"""The port's CUDA kernels (K4 hit table, K1 hits field, K2 its backward)
against their plain torch twins on the card, at small shapes. On a machine
without CUDA these tests skip (the `cuda` fixture decides, at run time);
run them on the card with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py`
(the file imports neither jax nor the repo's conftest, which imports jax:
the card's machine has no jax). The CPU-only checks at the end run
everywhere.

Tolerances as in chip_smoke.py: integers, depths and positions exact (the
kernels round exactly like the plain ops: no FMA contraction, IEEE
division); features 1e-6; d xyz 1e-5 relative; d packed 1e-5 of its
largest entry (float atomics add in a varying order)."""

import os

import numpy as np
import pytest
import torch

from nerfloam_tpu_torch import kernels
from nerfloam_tpu_torch.core import render as trender
from nerfloam_tpu_torch.map import voxel_map as vm
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
    ms = vm.recenter(vm.create(T_CFG), T_CFG, torch.zeros(3))
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
        feats, *_ = trender.hits_field(packed, oo, dd, h, u.to(dev), T_CFG.voxel_size)
        (feats * torch.linspace(-1, 1, 16, device=dev)).sum().backward()
        grads[dev.type] = [x.grad.cpu() for x in (packed, oo, dd)]
    for k, c in zip(grads["cuda"], grads["cpu"]):
        assert float((k - c).abs().max()) <= 1e-5 * float(c.abs().max())


def test_wrappers_reject_other_devices():
    ms, o, d, tc = _case("cpu")
    meta = [x.to("meta") for x in (o, d, tc)]
    with pytest.raises(ValueError, match="unsupported device"):
        trc.build_hit_table(ms, T_CFG, T_RC, *meta)
    ht = trc.build_hit_table(ms, T_CFG, T_RC, o, d, tc)
    with pytest.raises(ValueError, match="unsupported device"):
        trender.hits_field_fwd(ht, torch.zeros(o.shape[0], 4), o, d, ms.packed.to("meta"), 0.5)


def test_kernel_library_is_built_lazily():
    # importing the port builds nothing; the library name carries a source hash
    path = kernels.library_path()
    assert os.path.dirname(path) == kernels.BUILD_DIR
    assert len(os.path.basename(path).split("_")[-1]) == len("0123456789abcdef.so")
    assert kernels._lib is None or torch.cuda.is_available()
    assert "-fmad=false" in kernels.NVCC_FLAGS and "--use_fast_math" not in kernels.NVCC_FLAGS
