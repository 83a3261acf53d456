"""Port parity: the GN iteration's tail (``tracking.lm_tail``, csrc/
lm_step.cu; its twin ``lm_tail_plain`` on the CPU) against the JAX package
on the CPU (nerfloam_tpu/core/tracking.py:326-334 and the next iteration's
rotate_dirs, :249).

- The damping, ``lm_damping_plain``, bit-equal to JAX's jitted
  ``H + lam diag(diag(H)) + 1e-6 I``.
- The solve, ``damped_solve_plain`` (f32 LU with partial pivoting, one
  IEEE rounding an operation), on 4,800 damped systems built as the
  tracker builds them (weighted sums of J J^T over samples with lever arms
  of 2-40 m; a quarter from gradients on one plane, a quarter on two,
  ill-conditioned): backward stable (its residual within 2 n eps of
  |Hd| |x| + |b| in the infinity norms on every system, as
  torch.linalg.solve's), and against
  ``jnp.linalg.solve`` (LAPACK's f32 getrf and trsm, OpenBLAS's kernels)
  as close as ``torch.linalg.solve`` (MKL's), the port's solve before,
  to within 15% in the median and 30% in the mean of each system's
  relative error (largest |x - x_jax| over largest |x_jax|): measured 9%
  and 21% above it. No f32 LU reproduces either library's bits; the
  variants that come below MKL's error (fused multiply-adds, float64
  with one rounding) flip CPU tests that compare runs differing in their
  last bits (a deferred replay after a growth, the schedules, JAX's
  replay windows), so the port keeps the plain rounding of the rest of
  its kernels. All printed.
- The whole tail: JAX's jitted step after its solve, and its rotate_dirs at
  the new pose. Each pose within what its solve's gap to JAX's moves it:
  2 |x - x_jax| (the trust region is a projection, and the rotation's
  log map of a composition moves with its step to within a few percent at
  these angles) plus 8 ulp of the pose's largest entry (the step's own
  rounding, test_torch_lm_step). Fed JAX's pose, the rays as the next
  iteration's body rotates the carried pose (rotate_dirs jitted on its
  own): with JAX's jitted rotation matrix, ``se3.rotate_rows`` is bit-equal
  to it (the product is XLA's fma chain); with the port's own R, which is
  JAX's op-by-op exp_so3 bit for bit, within what R's gap explains (2
  sqrt(3) r + 1 ulp of each ray's largest entry for R r ulp of 1 apart:
  jitted XLA rounds exp_so3's chain otherwise than its op-by-op form, ~1-2
  ulp of 1).
- ``lm_tail`` on the CPU is ``lm_tail_plain``, batched or one system a
  call; its R is ``se3.pose_rotation`` of its pose."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloam_tpu.ops import se3 as jse3
from nerfloam_tpu_torch.core import tracking as ttr
from nerfloam_tpu_torch.ops import se3 as tse3

torch.set_num_threads(2)
LAM = 1e-2
N_SYS = 4800


def _systems(n, seed=0, rows=512):
    """n (H, b) like a GN iteration's: J = [g, q x g] (g unit gradients,
    scaled by the band's truncation on most samples; q lever arms of 2-40
    m), weights of the front (0.7) and band (3000) classes, 20% of samples
    masked out; every fourth system from gradients on one plane and every
    fourth + 2 on two planes (ill-conditioned)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, rows, 3))
    g[1::4] = [0.02, 0.01, 1.0] + rng.normal(size=(len(g[1::4]), rows, 3)) * 1e-3
    two = np.where(rng.random((len(g[2::4]), rows, 1)) < 0.5, [0.0, 0.0, 1.0], [1.0, 0.0, 0.0])
    g[2::4] = two + rng.normal(size=two.shape) * 1e-2
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    front = rng.random((n, rows, 1)) < 0.3
    gj = g * np.where(front, 1.0, 0.3)
    q = rng.normal(size=(n, rows, 3)) * rng.uniform(2, 40, (n, rows, 1))
    J = np.concatenate([gj, np.cross(q, gj)], -1).astype(np.float32)
    w = (np.where(front, 0.7, 3000.0) * (rng.random((n, rows, 1)) < 0.8)).astype(np.float32)
    r = rng.normal(0, 0.05, (n, rows)).astype(np.float32)
    H = np.einsum("nri,nrj->nij", (J * w).astype(np.float64), J).astype(np.float32)
    b = np.einsum("nri,nr->ni", (J * w).astype(np.float64), r).astype(np.float32)
    return H, b


def _poses(n, seed=1):
    """Poses 10 m from the origin, half in exp_so3's series branch."""
    rng = np.random.default_rng(seed)
    w = np.where((np.arange(n) < n // 2)[:, None], rng.normal(0, 3e-5, (n, 3)),
                 rng.normal(0, 0.8, (n, 3)))
    return np.concatenate([rng.normal(0, 10, (n, 3)), w], 1).astype(np.float32)


def _jax_damp(H, lam):
    return H + lam * jnp.diag(jnp.diag(H)) + 1e-6 * jnp.eye(6)


def _jax_tail(pose6, H, b, lam, dirs):
    """nerfloam_tpu/core/tracking.py:326-334, then :249 at the new pose."""
    delta = -jnp.linalg.solve(_jax_damp(H, lam), b)
    dt = delta[:3]
    dth = delta[3:]
    dt = dt * jnp.minimum(1.0, 0.5 / (jnp.linalg.norm(dt) + 1e-12))
    dth = dth * jnp.minimum(1.0, 0.1 / (jnp.linalg.norm(dth) + 1e-12))
    R_new = jse3.compose_matrices(jse3.exp_so3(dth), jse3.pose_rotation(pose6))
    pose_try = jnp.concatenate([pose6[:3] + dt, jse3.log_so3(R_new)])
    return pose_try, jse3.rotate_dirs(pose_try, dirs)


@pytest.fixture(scope="module")
def case():
    H, b = _systems(N_SYS)
    lam = jnp.asarray(LAM, jnp.float32)  # the tracker's carry
    solve = jax.jit(jax.vmap(lambda H_, b_: jnp.linalg.solve(_jax_damp(H_, lam), b_)))
    return H, b, np.asarray(solve(jnp.asarray(H), jnp.asarray(b)))


def _rel(x, ref):
    """Each system's largest |x - ref| over its largest |ref|."""
    return np.abs(x.astype(np.float64) - ref).max(-1) / np.abs(ref).max(-1)


def test_damping_matches_jax(case):
    """lm_damping_plain bit-equal to JAX's jitted damping, lam a float32
    carry as in the tracker's loop."""
    H, _, _ = case
    lam = jnp.asarray(LAM, jnp.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda H_: _jax_damp(H_, lam)))(jnp.asarray(H)))
    np.testing.assert_array_equal(ttr.lm_damping_plain(torch.as_tensor(H), LAM).numpy(), want)


def test_damped_solve_as_close_to_jax_as_torch_solve(case):
    """The LU is backward stable, and its error against jnp.linalg.solve is
    within 15% (median) and 30% (mean) of torch.linalg.solve's."""
    H, b, want = case
    Ht, bt = torch.as_tensor(H), torch.as_tensor(b)
    got = ttr.damped_solve_plain(Ht, bt, LAM)
    Hd = ttr.lm_damping_plain(Ht, LAM)
    parent = torch.linalg.solve(Hd, bt)
    exact = torch.linalg.solve(Hd.double(), bt.double()).numpy()
    eps = float(np.finfo(np.float32).eps)

    def backward(x):  # |Hd x - b| / (|Hd| |x| + |b|) in the infinity norms, in float64
        x64, A, b64 = x.double(), Hd.double(), bt.double()
        r = (A @ x64[..., None])[..., 0] - b64
        norm_a = A.abs().sum(-1).amax(-1)
        return (r.abs().amax(-1) / (norm_a * x64.abs().amax(-1) + b64.abs().amax(-1))).numpy()

    got, parent = got.numpy(), parent.numpy()
    e_got, e_parent = _rel(got, want), _rel(parent, want)
    print(f"[gn tail] {N_SYS} damped systems against jnp.linalg.solve, relative error: the LU's "
          f"median {np.median(e_got):.4g}, mean {e_got.mean():.4g}, max {e_got.max():.4g}, "
          f"bit-equal {(got == want).all(1).mean():.4f}; torch.linalg.solve's median "
          f"{np.median(e_parent):.4g}, mean {e_parent.mean():.4g}, max {e_parent.max():.4g}, "
          f"bit-equal {(parent == want).all(1).mean():.4f}; against the float64 solve, median: "
          f"the LU's {np.median(_rel(got, exact)):.4g}, torch's "
          f"{np.median(_rel(parent, exact)):.4g}; backward error, max: the LU's "
          f"{backward(torch.as_tensor(got)).max() / eps:.3g} eps, torch's "
          f"{backward(torch.as_tensor(parent)).max() / eps:.3g} eps")
    assert np.isfinite(got).all()
    assert backward(torch.as_tensor(got)).max() <= 2 * 6 * eps
    assert np.median(e_got) <= 1.15 * np.median(e_parent)
    assert e_got.mean() <= 1.3 * e_parent.mean()
    # one system a call: the batch's rows
    for i in (0, 5, N_SYS - 1):
        one = ttr.damped_solve_plain(torch.as_tensor(H[i]), torch.as_tensor(b[i]), LAM)
        np.testing.assert_array_equal(one.numpy(), got[i])


def test_lm_tail_matches_jax(case):
    """The whole tail against JAX's jitted tail, and the rays at JAX's pose."""
    H, b, _ = case
    n = 400
    pose = _poses(n)
    rng = np.random.default_rng(2)
    dirs = rng.normal(size=(n, 64, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    lam = jnp.asarray(LAM, jnp.float32)
    tail = jax.jit(jax.vmap(lambda p, H_, b_, d: _jax_tail(p, H_, b_, lam, d)))
    jpose, jrays = (np.asarray(x) for x in tail(*(jnp.asarray(x) for x in (pose, H[:n], b[:n],
                                                                            dirs))))
    got, R, rays = ttr.lm_tail(*(torch.as_tensor(x) for x in (pose, H[:n], b[:n])), LAM,
                               torch.as_tensor(dirs))
    got, R, rays = got.numpy(), R.numpy(), rays.numpy()
    np.testing.assert_array_equal(R, tse3.pose_rotation(torch.as_tensor(got)).numpy())
    x_port = ttr.damped_solve_plain(torch.as_tensor(H[:n]), torch.as_tensor(b[:n]), LAM).numpy()
    x_jax = np.asarray(jax.jit(jax.vmap(lambda H_, b_: jnp.linalg.solve(_jax_damp(H_, lam), b_)))(
        jnp.asarray(H[:n]), jnp.asarray(b[:n])))
    dx = np.linalg.norm(x_port.astype(np.float64) - x_jax, axis=-1)
    gap = np.abs(got.astype(np.float64) - jpose).max(-1)
    ulp = np.spacing(np.abs(jpose).max(-1).astype(np.float32)).astype(np.float64)
    print(f"[gn tail] {n} tails against JAX's jitted tail: each pose within {gap.max():.4g} "
          f"(at most {(gap / (2 * dx + 8 * ulp)).max():.3g} of 2 |x - x_jax| + 8 ulp), poses "
          f"bit-equal {(gap == 0).mean():.4f}")
    assert (gap <= 2 * dx + 8 * ulp).all()
    # fed JAX's pose: the rays as the next iteration's body rotates them (the
    # pose is the loop's carry; rotate_dirs jitted on its own)
    jp = jnp.asarray(jpose)
    next_rays = np.asarray(jax.jit(jax.vmap(jse3.rotate_dirs))(jp, jnp.asarray(dirs)))
    jit_R = np.asarray(jax.jit(jax.vmap(jse3.pose_rotation))(jp))
    op_R = np.asarray(jax.vmap(jse3.pose_rotation)(jp))
    port_R = tse3.pose_rotation(torch.as_tensor(jpose))
    np.testing.assert_array_equal(port_R.numpy(), op_R)
    with_jit_R = tse3.rotate_rows(torch.as_tensor(dirs), torch.as_tensor(jit_R)).numpy()
    np.testing.assert_array_equal(with_jit_R, next_rays)
    at_jax = tse3.rotate_rows(torch.as_tensor(dirs), port_R).numpy()
    ray_ulp = np.spacing(np.abs(next_rays).max(-1, keepdims=True).astype(np.float32))
    off = np.abs(at_jax.astype(np.float64) - next_rays) / ray_ulp
    r_ulp = np.abs(port_R.numpy().astype(np.float64) - jit_R).max() / np.spacing(np.float32(1))
    print(f"[gn tail] the rays at JAX's pose: with JAX's jitted R bit-equal to its jitted "
          f"rotate_dirs; with the port's R (JAX's op-by-op exp_so3, bit for bit; the jitted R "
          f"within {r_ulp:g} ulp of 1 of it) within {off.max():g} ulp of each ray's largest "
          f"entry, rays bit-equal {(at_jax == next_rays).all(-1).mean():.4f}")
    # a gap of R's entries of r ulp of 1 moves a unit ray's entry by sqrt(3) r
    # ulp of 1, at most 2 sqrt(3) r ulp of its largest entry (>= 1 / sqrt(3))
    assert off.max() <= 2 * np.sqrt(3) * r_ulp + 1
    # one system a call: the batch's rows
    for i in (0, n - 1):
        one = ttr.lm_tail(*(torch.as_tensor(x[i]) for x in (pose, H, b)), LAM,
                          torch.as_tensor(dirs[i]))
        for a, full in zip(one, (got, R, rays)):
            np.testing.assert_array_equal(a.numpy(), full[i])


def test_lm_tail_checks_its_inputs():
    p, H, b, d = torch.zeros(6), torch.eye(6), torch.zeros(6), torch.zeros(8, 3)
    for bad in ((p.double(), H, b, d), (p, H[:5], b, d), (p, H.t().contiguous()[:, :5], b, d),
                (p, H, b, d[:, :2]), (p, H, b[:5], d), (p.requires_grad_(True), H, b, d)):
        with pytest.raises(ValueError):
            ttr.lm_tail(bad[0], bad[1], bad[2], LAM, bad[3])
