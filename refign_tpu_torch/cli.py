"""Command-line interface of the port: fit / validate / test / predict
(counterpart of ``refign_tpu/cli.py``; ``tools/run.py`` stays the JAX
package's entry point).

    python -m refign_tpu_torch.cli {fit,validate,test,predict} \\
        --config configs/<...>.yaml [--ckpt_path ...] [--workdir ...] \\
        [--data_dir ...] [--seed N] [--device cuda|cpu] [--a.b.c VALUE ...]

Reference-schema YAML configs; dot-overrides for any config key
(``--trainer.max_steps 10``, ``--data.init_args.batch_size 2``), with a
typo guard on sections.  The run is on the card; ``--device cpu`` runs it
on the CPU, and without a card and without that flag it raises.

Data parallel: under torch's launcher,

    python -m torch.distributed.run --nproc_per_node N \
        -m refign_tpu_torch.cli fit --config ... [--device cpu]

each process reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` and joins the process group (NCCL, rank
r on ``cuda:LOCAL_RANK``; gloo with ``--device cpu``); the group is
destroyed at exit.  Rank 0 alone prints results and writes files.
"""
from __future__ import annotations

import argparse
import json
import os
import random as pyrandom
import sys
from typing import Any, Dict, List

import numpy as np


def _apply_override(cfg: Dict[str, Any], dotted: str, value: str) -> None:
    keys = dotted.split(".")
    node = cfg
    for j, k in enumerate(keys[:-1]):
        # a SECTION must already exist (typo guard, as jsonargparse
        # rejects unknown sections); an empty YAML section (`trainer:`)
        # parses as None and is replaced by a fresh mapping
        if k not in node:
            raise SystemExit(
                f"--{dotted}: config has no section "
                f"'{'.'.join(keys[:j + 1])}' (check spelling)")
        if node.get(k) is None:
            node[k] = {}
        if not isinstance(node[k], dict):
            raise SystemExit(
                f"--{dotted}: config node '{k}' is not a mapping "
                f"({type(node[k]).__name__})")
        node = node[k]
    if keys[-1] not in node:
        # a new leaf can legitimately override an omitted default, but it
        # is also how a typo disappears into the known-argument filters
        print(f"[cli] note: --{dotted} introduces a NEW config key "
              f"(not present in the YAML) — check the spelling if you "
              f"expected to override an existing value", file=sys.stderr)
    try:
        parsed = json.loads(value)
    except (json.JSONDecodeError, TypeError):
        parsed = value
    node[keys[-1]] = parsed


def main(argv: List[str] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser("refign-tpu-torch")
    parser.add_argument("subcommand",
                        choices=["fit", "validate", "test", "predict"])
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt_path", default=None)
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--data_dir", default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args, overrides = parser.parse_known_args(argv)

    from .config import load_yaml
    cfg = load_yaml(args.config)
    i = 0
    while i < len(overrides):
        key = overrides[i]
        if not key.startswith("--"):
            raise SystemExit(f"unknown argument {key}")
        if "=" in key:
            dotted, value = key[2:].split("=", 1)
            i += 1
        else:
            if i + 1 >= len(overrides):
                raise SystemExit(f"override {key} is missing a value")
            dotted, value = key[2:], overrides[i + 1]
            i += 2
        _apply_override(cfg, dotted, value)

    seed = args.seed if args.seed is not None else int(
        cfg.get("seed_everything", 0))
    pyrandom.seed(seed)
    np.random.seed(seed)

    # reference configs define trainer.logger as a LIST of class_path
    # entries (refign_hrda_star.yaml:165-169), ours a single mapping:
    # accept both (and null sections) when deriving the save dir
    logger_cfg = (cfg.get("trainer") or {}).get("logger") or {}
    if isinstance(logger_cfg, list):
        logger_cfg = next(
            (e for e in logger_cfg if isinstance(e, dict)
             and "save_dir" in (e.get("init_args") or {})), {})
    save_dir = (logger_cfg.get("init_args") or {}).get("save_dir", "runs")
    workdir = args.workdir or os.path.join(
        save_dir, os.path.splitext(os.path.basename(args.config))[0])

    # fp32 products in full fp32, as the JAX package sets
    # jax_default_matmul_precision="highest" (bf16 compute is unaffected)
    from . import full_fp32_precision
    from .parallel import mesh
    full_fp32_precision()
    _, _, device = mesh.init_distributed(args.device)
    try:
        return _run(args, cfg, seed, workdir, device)
    finally:
        mesh.destroy_distributed()


def _run(args, cfg, seed: int, workdir: str, device) -> int:
    from .config import build_task
    from .parallel import mesh
    task, _ = build_task(cfg, data_dir=args.data_dir, device=device)
    if args.subcommand == "predict" and not hasattr(task, "predict"):
        raise SystemExit(
            f"'predict' is not supported for {type(task).__name__} "
            "(the reference AlignmentModel defines no predict_step either)")

    if args.subcommand == "fit":
        task.fit(workdir, seed=seed, resume=args.ckpt_path)
        return 0

    trainer = task.restore(args.ckpt_path, seed) if args.ckpt_path else None
    if args.subcommand in ("validate", "test"):
        stage = "val" if args.subcommand == "validate" else "test"
        metrics = task.evaluate(stage, trainer)
        if mesh.is_main():
            print(json.dumps(metrics, indent=2))
            os.makedirs(workdir, exist_ok=True)
            with open(os.path.join(workdir, f"{stage}_metrics.json"),
                      "w") as f:
                json.dump(metrics, f, indent=2)
        return 0

    task.predict(workdir, trainer)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
