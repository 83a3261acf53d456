"""The replica gate (data seed 0) of the PyTorch port under several
generator seeds (``tpu_specs.seed``), with the reference-exact fallbacks
and without: one JSON line a run with its raw and aligned ATE, lateral
drift and per-frame raw error, on one CUDA card, no thresholds.

    python3 scripts/gate_seeds_torch.py 777,778,779

The JAX package's counterpart on a CPU, one run a seed:
``JAX_PLATFORMS=cpu python scripts/port_ate_reference.py --gate60 0
[--exact] --tpu-seed N``."""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nerfloam_tpu_torch.core.pipeline import NerfLoamSLAM_torch  # noqa: E402
from nerfloam_tpu_torch.data import get_dataset  # noqa: E402
from nerfloam_tpu_torch.utils.config import finalize  # noqa: E402
from nerfloam_tpu_torch.utils.evaluation import ate_rmse  # noqa: E402

here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for exact in (True, False):
    for ts in [int(x) for x in sys.argv[1].split(",")]:
        with open(os.path.join(here, "nerfloam_tpu_torch", "configs", "replica_gate60.json")) as f:
            d = json.load(f)
        d["data_specs"]["seed"] = 0
        d["tpu_specs"]["seed"] = ts
        if exact:
            d["tpu_specs"].update(cs.EXACT_OVERRIDES)
        cfg = finalize(d)
        ds = get_dataset(cfg)
        slam = NerfLoamSLAM_torch(cfg, ds, device="cuda")
        frames = cs.make_frames(slam, ds)
        t0 = time.perf_counter()
        slam.process_first_frame(frames[0])
        for f in frames[1:]:
            slam.process_frame(f)
        poses = np.asarray(slam.finalize())
        gt = ds.gt_trajectory()[: len(poses)]
        err = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1)
        r = {"exact": exact, "tpu_seed": ts, "raw": ate_rmse(poses, gt, align=False),
             "aligned": ate_rmse(poses, gt, align=True), "drift": cs.drift_lat_cm_f(poses, gt),
             "s": time.perf_counter() - t0, "err": [round(float(e), 4) for e in err]}
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
