"""Ray data parallelism over ``torch.distributed`` (port of the dp layout of
nerfloam_tpu/parallel/sharding.py:37-45, ``make_mesh``, and of the
pipeline's ``("dp",)`` mesh, nerfloam_tpu/core/pipeline.py:384-398), and the
dp x tp layout of the rest of that module (below: ``make_mesh``,
``shard_decoder_params``, ``tp_decoder_apply``,
``make_sharded_ba_iteration``).

Layout: one process a rank, rank r on a device named for it. The map, the
decoder, the poses and the optimizer state are replicated. Every rank draws
the same global rays and jitter from the same seed and renders its
contiguous block of them (``dp_cols``, JAX's ``_local_cols``); the loss
counts, K3's sums (with K11b's system) and every BA gradient are
all-reduced, so every rank applies the same update and the replicated state
stays bit-identical (dp changes only the order of float sums). The GN
tracker and BA are sharded; the Adam tracker runs whole on every rank, as
JAX's staged path does.

Backend (``backend_for``, printed by ``run_dp``): NCCL when every rank has a
card of its own; gloo when ranks share a card or run on the CPU (NCCL
refuses two ranks on one device; gloo all-reduces and broadcasts CUDA
tensors through the host, which is all dp needs). A caller may name the
backend; nothing switches backend after a failure.

``run_dp`` starts the ranks with ``torch.multiprocessing`` (spawn), meets
through a ``file://`` store in a temporary directory and returns rank 0's
result after checking every rank's final poses against it bit for bit.
``spawn`` runs any module-level function on such ranks. Nothing here
imports JAX: a spawned child imports only this package and the function's
own module.
"""

from __future__ import annotations

import copy
import datetime
import os
import pickle
import shutil
import tempfile
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

# how long a rank waits at the rendezvous and in a collective for the others
_TIMEOUT = datetime.timedelta(seconds=1800)


def dp_cols(group, n: int) -> slice:
    """This rank's contiguous block of ``n`` globally drawn rays under a dp
    ``group`` (every rank draws the same set), all of them without one.
    Raises ValueError unless dp divides ``n``."""
    if group is None:
        return slice(0, n)
    dp, rank = dist.get_world_size(group), dist.get_rank(group)
    if n % dp:
        raise ValueError(f"N_rays {n} not divisible by dp {dp}")
    return slice(rank * (n // dp), (rank + 1) * (n // dp))


def all_reduce_sum(tensors: list, group) -> list:
    """The ranks' sums of ``tensors`` by one all-reduce of one f32 buffer,
    each returned in its own dtype; every rank gets the same bits. The first
    tensor (BA's gradient of the packed table or of the embeddings) is row
    sparse: its rows are summed only where some rank's row is not all zero
    (one more all-reduce, of a row mask, finds them), so it moves its
    touched rows, not the table, and every other row stays 0 as the full
    sum would leave it."""
    first = tensors[0]
    some = (first != 0).reshape(first.shape[0], -1).any(1).to(torch.float32)
    dist.all_reduce(some, group=group)
    rows = some.nonzero()[:, 0]
    tensors = [first[rows], *tensors[1:]]
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    full = torch.zeros_like(first)
    full[rows] = out[0]
    return [full, *out[1:]]


def backend_for(devices) -> str:
    """The backend rule: "nccl" when every rank's device is a card of its
    own, else "gloo" (ranks on the CPU, or two ranks on one card)."""
    devs = [torch.device(d) for d in devices]
    own_cards = (all(d.type == "cuda" and d.index is not None for d in devs)
                 and len({d.index for d in devs}) == len(devs))
    return "nccl" if own_cards else "gloo"


def _default_devices(world_size: int) -> list:
    """Rank r on card r % count (every rank on the one card of a one-card
    machine); raises without CUDA: pass devices=["cpu"] * n for the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("run_dp: no CUDA device; pass devices=['cpu'] * world_size to run "
                           "the ranks on the CPU")
    n = torch.cuda.device_count()
    return [f"cuda:{r % n}" for r in range(world_size)]


def _indexed(device) -> str:
    """``device`` as a string with its card named ("cuda" is the current one)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def _entry(rank, fn, world_size, devices, backend, store, outdir, args):
    """One rank: its device, the process group, ``fn(rank, world_size,
    device, *args)``, its result pickled into ``outdir``."""
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)  # ranks x test workers would oversubscribe the host
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=world_size,
                            rank=rank, timeout=_TIMEOUT)
    try:
        out = fn(rank, world_size, dev, *args)
        tmp = os.path.join(outdir, f"rank{rank}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, os.path.join(outdir, f"rank{rank}.pkl"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, devices=None, backend: str | None = None, args=()) -> list:
    """Run ``fn(rank, world_size, device, *args)`` on ``world_size`` spawned
    ranks joined in one process group; return their results in rank order.
    ``fn`` must be a module-level function of a module that the children
    can import (it is pickled by name). ``devices``: one per rank (default:
    ``_default_devices``); ``backend``: "nccl" or "gloo" (default:
    ``backend_for(devices)``). A rank that raises makes this raise."""
    import torch.multiprocessing as mp

    devices = [_indexed(d) for d in devices] if devices is not None else _default_devices(
        world_size)
    if len(devices) != world_size:
        raise ValueError(f"spawn: {len(devices)} devices for {world_size} ranks")
    backend = backend or backend_for(devices)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"spawn: backend must be 'nccl' or 'gloo', got {backend!r}")
    work = tempfile.mkdtemp(prefix="nl_dp_")
    try:
        mp.start_processes(_entry, args=(fn, world_size, devices, backend,
                                         os.path.join(work, "store"), work, args),
                           nprocs=world_size, join=True, start_method="spawn")
        out = []
        for r in range(world_size):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run_pipeline(rank, world_size, device, cfg_dict, dataset_fn, probe, log_dir):
    """One rank of ``run_dp``: the pipeline over ``dataset_fn(cfg)`` with
    ``tpu_specs.dp = world_size`` (each rank given a logger into
    ``log_dir/rank<r>``, which the pipeline keeps for rank 0 alone), then
    its trajectory, the packed table's digest and ``probe(slam, rank)``."""
    import hashlib

    from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch
    from nerfloam_tpu_torch.utils.config import Config
    from nerfloam_tpu_torch.utils.logger import RunLogger

    cfg = Config(cfg_dict)
    logger = None if log_dir is None else RunLogger(os.path.join(log_dir, f"rank{rank}"))
    slam = NerfLoamSLAM_torch(cfg, dataset_fn(cfg), device, logger=logger)
    poses = np.stack([np.asarray(p, np.float64) for p in slam.run()])
    packed = slam.state.map_state.packed
    digest = hashlib.sha256(packed.detach().cpu().contiguous().view(torch.uint8).numpy()
                            .tobytes()).hexdigest()
    out = {"rank": rank, "poses": poses, "packed_sha256": digest}
    if probe is not None:
        out["probe"] = probe(slam, rank)
    return out


def run_dp(cfg, dataset_fn, world_size: int, devices=None, backend: str | None = None,
           probe=None, log_dir: str | None = None) -> dict:
    """The pipeline with rays split over ``world_size`` ranks (JAX's
    ``tpu_specs.dp``): ``cfg``'s ``tpu_specs.dp`` is set to ``world_size``,
    every rank builds ``dataset_fn(cfg)`` (a module-level function) and runs
    the whole sequence on its device. ``devices``: one per rank (default:
    rank r on card r mod the card count); ``backend``: as ``spawn``, the
    rule printed. ``probe(slam, rank)``, a module-level function, adds its
    picklable result to each rank's. ``log_dir``: the run's outputs (meshes,
    poses, checkpoints) under ``log_dir/rank0``; the other ranks write
    nothing.

    Returns rank 0's result: "poses" (F, 4, 4) float64, "packed_sha256"
    the final packed table's digest, "probe", and "ranks", every rank's
    result. Raises RuntimeError unless every rank's final poses are
    bit-equal to rank 0's."""
    devices = ([_indexed(d) for d in devices] if devices is not None
               else _default_devices(world_size))
    how = "named by the caller" if backend else (
        "the rule: nccl when every rank has a card of its own, gloo when ranks share a card "
        "or run on the CPU")
    backend = backend or backend_for(devices)
    print(f"[dp] {world_size} ranks on {', '.join(map(str, devices))}: backend {backend} ({how})",
          flush=True)
    d = copy.deepcopy(cfg._d)
    d["tpu_specs"]["dp"] = world_size
    ranks = spawn(_run_pipeline, world_size, devices, backend,
                  (d, dataset_fn, probe, log_dir))
    for r in ranks[1:]:
        if r["poses"].shape != ranks[0]["poses"].shape or not np.array_equal(
                r["poses"].view(np.uint64), ranks[0]["poses"].view(np.uint64)):
            raise RuntimeError(f"run_dp: rank {r['rank']}'s final poses differ from rank 0's: "
                               "the replicated state drifted")
    return {**ranks[0], "ranks": ranks}


# ------------------------------------------------- the dp x tp layout (tp)
#
# Port of nerfloam_tpu/parallel/sharding.py:37-228: make_mesh's dp x tp
# split, the Megatron decoder split and the multi-chip BA iteration that
# __graft_entry__.dryrun_multichip runs as its layout 2. JAX runs the body
# under shard_map(check_vma=False), where psum's transpose is psum: the
# cotangent reaching each rank's partial product is summed over the tp
# ranks, and the pmean over dp hands every rank's local loss a cotangent
# of 1. Measured on JAX 0.9's CPU mesh (tests/test_torch_tp.py): the raw
# gradients of the column- and row-split decoder leaves come out tp times
# the single-device ones, the replicated leaves (the row layers' biases,
# the output head) equal them, every gradient is dp times the gradient of
# the loss the step returns (local counts, then the pmean), and the
# gradients of the packed table and of the pose are each rank's own column
# block's share, times tp, never summed over tp, so those two replicated
# outputs differ between the tp ranks of a row and stay equal down a tp
# column. The port's collectives (``_AllReduceSum``) take the same rule,
# so each rank holds the numbers of JAX's device at its mesh coordinates.


class Mesh(NamedTuple):
    """This rank's place in a dp x tp layout (JAX's ``Mesh`` with axes
    ("dp", "tp") over devices laid out ``reshape(dp, tp)``: the rank of
    (i, j) is i * tp + j). ``tp_group`` holds the tp ranks of this rank's
    dp row (the decoder's partial sums), ``dp_group`` the dp ranks of its
    tp column (the gradient sums); a group is None where it would hold this
    rank alone."""

    dp: int
    tp: int
    dp_index: int
    tp_index: int
    dp_group: object = None
    tp_group: object = None


def mesh_shape(n_devices: int, tp: int | None = None) -> tuple[int, int]:
    """(dp, tp) of ``make_mesh`` over ``n_devices``: tp = 2 when n is even
    and at least 4, else 1 (JAX sharding.py:41-44); raises ValueError unless
    tp divides n."""
    n = int(n_devices)
    if tp is None:
        tp = 2 if n % 2 == 0 and n >= 4 else 1
    if tp < 1 or n % tp:
        raise ValueError(f"make_mesh: tp {tp} does not divide {n} devices")
    return n // tp, int(tp)


def make_mesh(n_devices: int | None = None, tp: int | None = None) -> Mesh:
    """The dp x tp layout over the ranks of the default process group
    (every rank must call it, in the same order as its other group
    creations: it makes one group per dp row and per tp column). Without a
    process group, ``n_devices`` must be 1 (or None): the one-process
    layout, dp = tp = 1."""
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(f"make_mesh: {n_devices} devices need a process group of as "
                             "many ranks (parallel.sharding.spawn)")
        mesh_shape(1, tp)
        return Mesh(1, 1, 0, 0)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh: {n} devices but the process group has {world} ranks")
    dp, tp = mesh_shape(n, tp)
    tp_group = dp_group = None
    for i in range(dp):  # new_group is collective: every rank makes every group
        g = dist.new_group([i * tp + j for j in range(tp)])
        if i == rank // tp and tp > 1:
            tp_group = g
    for j in range(tp):
        g = dist.new_group([i * tp + j for i in range(dp)])
        if j == rank % tp and dp > 1:
            dp_group = g
    return Mesh(dp, tp, rank // tp, rank % tp, dp_group, tp_group)


def _tp_block(width: int, mesh: Mesh) -> slice:
    if width % mesh.tp:
        raise ValueError(f"tp {mesh.tp} does not divide the decoder width {width}")
    b = width // mesh.tp
    return slice(mesh.tp_index * b, (mesh.tp_index + 1) * b)


def shard_decoder_params(params, mesh: Mesh):
    """This rank's decoder blocks for tp (JAX sharding.py:47-68): layer 0
    column-split (its columns of ``w`` and of ``b``), layers 1 and after
    row-split (their rows of ``w``, ``b`` replicated), the output layer and
    ``gaussian_B`` replicated. Returns a decoder dict of contiguous copies."""
    ws, bs = params["w"], params["b"]
    if len(ws) < 3:
        raise ValueError("tp_decoder: the split needs two hidden layers or more (JAX's "
                         "tp_decoder_apply reads the last row layer's output)")
    blk = _tp_block(ws[0].shape[1], mesh)
    out = {"w": [ws[0][:, blk].contiguous()], "b": [bs[0][blk].contiguous()]}
    for w, b in zip(ws[1:-1], bs[1:-1]):
        out["w"].append(w[_tp_block(w.shape[0], mesh)].contiguous())
        out["b"].append(b.clone())
    out["w"].append(ws[-1].clone())
    out["b"].append(bs[-1].clone())
    if "gaussian_B" in params:
        out["gaussian_B"] = params["gaussian_B"].clone()
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``'s ranks; the backward sums the cotangent over the
    same ranks: JAX's psum and its transpose under shard_map(check_vma=
    False). A None group is one rank: the identity both ways."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        if group is not None:
            dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        if ctx.group is not None:
            dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """JAX's ``lax.psum`` over ``group`` (see ``_AllReduceSum``)."""
    return _AllReduceSum.apply(x, group)


def _dot(h, w, compute_dtype):
    if compute_dtype != torch.float32:  # models/decoder.decoder_apply's bf16 rounding
        h, w = h.to(compute_dtype).float(), w.to(compute_dtype).float()
    return torch.matmul(h, w)


def tp_decoder_apply(params, feats: torch.Tensor, mesh: Mesh, compute_dtype=torch.float32):
    """The Megatron split of the (no-embedder, no-skip) sdf MLP on this
    rank (JAX sharding.py:71-99): layer 0's column block, a local product
    and ReLU; each row layer a partial product of this rank's block, its
    sum over the tp ranks (``psum``), the bias and ReLU, then this rank's
    column block of the result for the next row layer; the replicated
    output head on the last row layer's whole output. ``params`` from
    ``shard_decoder_params``; the products stay ``torch.matmul``, as JAX's
    ``jnp.dot`` outside any kernel, with ``compute_dtype`` rounding both
    operands as ``decoder_apply`` does. Returns (..., 1)."""
    ws, bs = params["w"], params["b"]
    if len(ws) < 3:
        raise ValueError("tp_decoder: the split needs two hidden layers or more (JAX's "
                         "tp_decoder_apply reads the last row layer's output)")
    h = torch.relu(_dot(feats, ws[0], compute_dtype) + bs[0])
    for w, b in zip(ws[1:-1], bs[1:-1]):
        hfull = torch.relu(psum(_dot(h, w, compute_dtype), mesh.tp_group) + b)
        h = hfull[..., _tp_block(hfull.shape[-1], mesh)]
    return _dot(hfull, ws[-1], compute_dtype) + bs[-1]


def make_sharded_ba_iteration(map_cfg, rc, truncation: float, max_depth: float,
                              fs_weight: float = 1.0, sdf_weight: float = 10000.0,
                              mesh: Mesh | None = None):
    """One multi-rank BA iteration (JAX sharding.py:102-226): rays split
    over dp in contiguous blocks, the decoder split over tp, the map
    replicated; the production optimizer (``tracking.scale_by_adam_``,
    optax's Adam step bit for bit) and ``p - lr * update``.

    Returns (step, init_opt): ``opt_state = init_opt(map_state, dec_local,
    pose6)``, then ``packed, dec_local, pose6, loss, opt_state =
    step(map_state, dec_local, pose6, pts_local, cos_local, rvalid_local,
    lrs, u, opt_state)``: ``dec_local`` from ``shard_decoder_params``,
    ``pts_local`` (R_local, 3) sensor-frame points, ``cos_local`` and
    ``rvalid_local`` (R_local,) this rank's block of the rays, ``lrs`` the
    three learning rates (table, decoder, pose) and ``u`` (R_local, M) the
    placement jitter. JAX's body draws its jitter from the replicated key,
    so every dp rank takes the same ``u``; the port is handed it.

    The body: the ray directions and their useful range (``ray_prep``:
    JAX's ``+ 1e-8`` normalisation and ``t_cap_for``), the grid sampler
    (K9a, K9b) at the rays of ``pose6``, the features of each sample's own
    cell (K8 forward, K2's d packed form backward), ``tp_decoder_apply`` in
    float32, ``sdf_losses`` on this rank's rays, its mean over the dp ranks,
    then every gradient summed over the dp ranks. The collectives follow
    JAX's transpose rule (see ``_AllReduceSum``). ``mesh`` None is one
    process (dp = tp = 1)."""
    from nerfloam_tpu_torch.core.losses import MAX_DEPTH, sdf_losses
    from nerfloam_tpu_torch.core.render import (
        ActiveField,
        DpackedScratch,
        _FieldColumns,
        grid_columns_fwd,
    )
    from nerfloam_tpu_torch.core.tracking import ray_prep, scale_by_adam_
    from nerfloam_tpu_torch.models.decoder import decoder_leaves, map_decoder
    from nerfloam_tpu_torch.ops import se3
    from nerfloam_tpu_torch.ops.raycast import CdfPlacer

    mesh = Mesh(1, 1, 0, 0) if mesh is None else mesh
    scratch = DpackedScratch()  # K2's d packed scratch, kept over the steps

    def init_opt(map_state, dec_params, pose6):
        params = [map_state.packed, *decoder_leaves(dec_params), pose6]
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def step(map_state, dec_params, pose6, pts, cos, rvalid, lrs, u, opt_state):
        packed = map_state.packed.detach().clone().requires_grad_(True)
        dec = map_decoder(dec_params, lambda p: p.detach().clone().requires_grad_(True))
        pose = pose6.detach().clone().requires_grad_(True)
        params = [packed, *decoder_leaves(dec), pose]
        dirs, t_cap, _, _, dnorm = ray_prep(pts, cos, truncation, max_depth)
        wdirs = se3.rotate_dirs(pose, dirs)
        origin = se3.pose_translation(pose).expand_as(wdirs)
        with torch.no_grad():  # K9a at the rays of pose6, into the placer K9b reads
            placer = CdfPlacer.march(map_state, map_cfg, rc, origin.detach(), wdirs.detach(),
                                     t_cap, rc.n_samples)
        field = ActiveField(map_state, map_cfg)
        side = {}

        def fwd(p, o, d):
            out, side["ray_mask"] = grid_columns_fwd(field, placer, u, o, d, p)
            return out

        feats, z, valid, _, _ = _FieldColumns.apply(packed, origin, wdirs, fwd,
                                                    map_cfg.voxel_size, scratch)
        ray_mask = side["ray_mask"] & rvalid
        valid = valid & rvalid[:, None]
        sdf = tp_decoder_apply(dec, feats, mesh)[..., 0]
        sdf = torch.where(valid, sdf, 1.0)
        z_out = torch.where(valid, z, MAX_DEPTH)
        local, _ = sdf_losses(z_out, sdf, valid, ray_mask, pts, cos, truncation, max_depth,
                              fs_weight, sdf_weight, gt_norm=dnorm)
        loss = psum(local, mesh.dp_group) / mesh.dp  # JAX's pmean over dp
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if mesh.dp_group is not None:
            grads = all_reduce_sum(grads, mesh.dp_group)
        with torch.no_grad():
            t = opt_state["count"] + 1
            mu, nu = opt_state["mu"], opt_state["nu"]
            lr_of = [lrs[0]] + [lrs[1]] * (len(params) - 2) + [lrs[2]]
            new = [p.detach() - lr * scale_by_adam_(g, m, v, t)
                   for p, g, m, v, lr in zip(params, grads, mu, nu, lr_of)]
        n_dec = len(params) - 2
        leaves = new[1:1 + n_dec]
        nw = len(dec["w"])
        dec_new = {"w": leaves[:nw], "b": leaves[nw:2 * nw]}
        if "gaussian_B" in dec:
            dec_new["gaussian_B"] = leaves[2 * nw]
        return new[0], dec_new, new[-1], loss.detach(), {"count": t, "mu": mu, "nu": nu}

    return step, init_opt
