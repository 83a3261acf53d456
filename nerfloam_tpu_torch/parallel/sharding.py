"""Ray data parallelism over ``torch.distributed`` (port of the dp layout of
nerfloam_tpu/parallel/sharding.py:37-45, ``make_mesh``, and of the
pipeline's ``("dp",)`` mesh, nerfloam_tpu/core/pipeline.py:384-398).

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
