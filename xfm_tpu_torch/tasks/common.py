"""What a task's main() shares (`xfm_tpu/tasks/common.py`): the config,
the output directory, the seed and the device; the epoch log."""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from ..core.config import dump_config, load_config, resolve_vision_config

_CONFIG_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "configs", "model")


def is_main_process() -> bool:
    """Rank 0 of an initialized process group, else true (one process)."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


@dataclasses.dataclass
class TaskContext:
    config: dict
    out_dir: str
    seed: int = 42
    device: str = "cuda"

    @classmethod
    def from_args(cls, args, overrides: Optional[dict] = None
                  ) -> "TaskContext":
        """The task YAML with `overrides`, its vision sub-config read (a
        missing relative path looked up under the repository's
        configs/model), `--bs` (the global train batch: one device a
        process, so the batch itself) and `--epoch` applied, and the result
        dumped to <output_dir>/config.yaml."""
        cfg = load_config(args.config, overrides)
        cfg = resolve_vision_config(cfg, config_root=_CONFIG_ROOT)
        if getattr(args, "bs", None) and "batch_size_train" in cfg:
            cfg["batch_size_train"] = args.bs
        if getattr(args, "epoch", None):
            cfg.setdefault("schedular", {})["epochs"] = args.epoch
        out = getattr(args, "output_dir", "output")
        os.makedirs(out, exist_ok=True)
        if is_main_process():
            dump_config(cfg, os.path.join(out, "config.yaml"))
        return cls(config=cfg, out_dir=out, seed=getattr(args, "seed", 42),
                   device=getattr(args, "device", "cuda"))


def append_log(out_dir: str, payload: dict) -> None:
    """One JSON line into <out_dir>/log.txt."""
    if is_main_process():
        with open(os.path.join(out_dir, "log.txt"), "a") as f:
            f.write(json.dumps(payload) + "\n")
