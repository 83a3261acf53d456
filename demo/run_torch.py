"""CLI entry point of the PyTorch + CUDA port:

    python demo/run_torch.py <config.json> [--group.key value]...
        [--set group.key=value]... [--resume DIR] [--device cuda] [--debug]

Loads a JSON config (nerfloam_tpu_torch/configs/*.json, the JSON twins of
the JAX package's YAML configs under nerfloam_tpu_torch/configs/shipped/,
or any dict of the JAX package's config groups), runs the whole SLAM
pipeline on the device, and writes the trajectory
(misc/frame_poses.{npy,txt}), the meshes (mesh/final_mesh.ply) and a final
checkpoint (ckpt/final) into a timestamped run directory under
``log_dir``/``exp_name``. As the JAX package's ``demo/run.py``, every leaf
key of the config is a flag (``--exp_name X``,
``--tracker_specs.num_iterations 10``); ``--set`` takes one override per
occurrence, applied last (values parsed as JSON, else as the JAX CLI
parses them); ``--resume`` continues from a checkpoint directory;
``--debug`` is accepted as the JAX CLI accepts it.
"""

import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

import numpy as np  # noqa: E402

from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch  # noqa: E402
from nerfloam_tpu_torch.data import get_dataset  # noqa: E402
from nerfloam_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from nerfloam_tpu_torch.utils.config import parse_cli  # noqa: E402
from nerfloam_tpu_torch.utils.logger import RunLogger  # noqa: E402


def main(argv=None):
    args, cfg = parse_cli(argv)
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
