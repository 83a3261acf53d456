"""CLI entry point of the PyTorch + CUDA port:

    python demo/run_torch.py <config.json> [--set group.key=value]...
        [--resume DIR] [--device cuda]

Loads a JSON config (nerfloam_tpu_torch/configs/*.json, or any dict of the
JAX package's config groups), runs the whole SLAM pipeline on the device,
and writes the trajectory (misc/frame_poses.{npy,txt}), the meshes
(mesh/final_mesh.ply) and a final checkpoint (ckpt/final) into a
timestamped run directory under ``log_dir``/``exp_name``. ``--set`` takes
one override per occurrence (values are parsed as JSON, else kept as
strings); ``--resume`` continues from a checkpoint directory.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

import numpy as np  # noqa: E402

from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch  # noqa: E402
from nerfloam_tpu_torch.data import get_dataset  # noqa: E402
from nerfloam_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from nerfloam_tpu_torch.utils.config import finalize  # noqa: E402
from nerfloam_tpu_torch.utils.logger import RunLogger  # noqa: E402


def apply_override(d: dict, item: str):
    key, sep, raw = item.partition("=")
    if not sep or not key:
        raise SystemExit(f"--set takes group.key=value, got {item!r}")
    try:
        value = json.loads(raw)
    except json.JSONDecodeError:
        value = raw
    *groups, name = key.split(".")
    for g in groups:
        d = d.setdefault(g, {})
    d[name] = value


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config")
    p.add_argument("--set", action="append", default=[], metavar="group.key=value")
    p.add_argument("--resume", default=None, metavar="DIR")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    with open(args.config) as f:
        d = json.load(f)
    for item in args.set:
        apply_override(d, item)
    cfg = finalize(d)
    np.random.seed(int(cfg.tpu_specs["seed"]))

    dataset = get_dataset(cfg)
    logger = RunLogger(cfg.get("log_dir", "./logs"), cfg.get("exp_name", "run"),
                       config=cfg.as_dict())
    slam = NerfLoamSLAM_torch(cfg, dataset, device=args.device, logger=logger)
    if args.resume:
        load_checkpoint(args.resume, slam)
        print(f"resumed from {args.resume} at frame {slam.state.frames_processed}")

    poses = slam.run()
    slam.prof.report()
    save_checkpoint(os.path.join(logger.dir, "ckpt", "final"), slam)
    print(f"done: {len(poses)} poses -> {logger.dir}")


if __name__ == "__main__":
    main()
