#!/usr/bin/env python3
"""Write the JSON twins of the JAX package's YAML configs.

    python scripts/yaml_configs_to_json.py [--check]

For every ``configs/<group>/<name>.yaml`` it writes
``nerfloam_tpu_torch/configs/shipped/<group>/<name>.json``: the config as
the JAX package loads it (``nerfloam_tpu.utils.config.load_config``: its
``base_config`` chain resolved, merged over the package's defaults), so the
port (``utils.config.load_json_config``, which needs no yaml) reads the
same config. ``--check`` writes nothing and exits 1 if a twin is missing or
differs. Needs ``yaml`` and the JAX package's config module (which does
not import jax); run it where the JAX package runs, not on the card.
"""

import argparse
import glob
import json
import os
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "nerfloam_tpu_torch", "configs", "shipped")


def twins() -> dict:
    """{json path: its text} for every YAML config of the JAX package."""
    from nerfloam_tpu.utils.config import load_config

    out = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True)):
        rel = os.path.relpath(path, os.path.join(ROOT, "configs"))
        d = load_config(path).as_dict()
        d.pop("base_config", None)  # resolved: the chain is merged into the dict
        out[os.path.join(OUT, os.path.splitext(rel)[0] + ".json")] = json.dumps(
            d, indent=1, sort_keys=True) + "\n"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true", help="compare, write nothing")
    args = ap.parse_args(argv)
    stale = []
    for path, text in twins().items():
        have = open(path).read() if os.path.exists(path) else None
        if have != text:
            stale.append(os.path.relpath(path, ROOT))
            if not args.check:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "w") as f:
                    f.write(text)
    verb = "differ" if args.check else "written"
    print(f"{len(stale)} twins {verb}" + (": " + ", ".join(stale) if stale else ""))
    return 1 if args.check and stale else 0


if __name__ == "__main__":
    sys.exit(main())
