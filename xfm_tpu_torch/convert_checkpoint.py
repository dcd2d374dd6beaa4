"""The port's checkpoint converter, the counterpart of the repository's
`scripts/convert_checkpoint.py to-torch`: a saved train state → a
reference `.th` state dict.

    python3 -m xfm_tpu_torch.convert_checkpoint to-torch SRC OUT.th \\
        --config C.yaml

SRC is a `state.pt` that `train/checkpoint.save_checkpoint` wrote, a step
directory holding one, or a checkpoint directory (its newest step). The
file holds whole tensors whatever layout wrote it (one process, data
parallel or FSDP), so any of them converts. The parameters are written
under the reference's names and layouts (`reference_names`, read against
the model config of the YAML: a BERT encoder under `bert.*`), f32; a
`DeepMLPHead` classifier as the `cls_head.{0…12}` that
`load_xfm_checkpoint` reads back, where the JAX package's
`export_xfm_checkpoint` writes every `cls_head` as an `MLPHead` and fails
on a deep one."""
from __future__ import annotations

import argparse
import os
from typing import Dict

import torch


def load_state_params(src: str) -> Dict[str, torch.Tensor]:
    """The parameters of a saved train state: `src` a `state.pt`, a step
    directory holding one, or a checkpoint directory (its newest step)."""
    from .train.checkpoint import load_params_from_checkpoint

    if os.path.isdir(src):
        if os.path.isfile(os.path.join(src, "state.pt")):
            src = os.path.join(src, "state.pt")
        else:
            return load_params_from_checkpoint(src)
    state = torch.load(src, map_location="cpu", weights_only=True)
    return state["params"] if "params" in state else state


def to_torch(src: str, dst: str, config_path: str) -> Dict[str, torch.Tensor]:
    """SRC's parameters under the reference's names, written to `dst` with
    `torch.save` → the state dict written."""
    from .core.config import load_config, resolve_vision_config
    from .models import config_from_yaml
    from .tasks.common import _CONFIG_ROOT
    from .train.checkpoint import reference_names

    cfg = resolve_vision_config(load_config(config_path),
                                config_root=_CONFIG_ROOT)
    sd = reference_names(load_state_params(src), config_from_yaml(cfg))
    torch.save(sd, dst)
    return sd


def main(argv=None) -> Dict[str, torch.Tensor]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("direction", choices=["to-torch"])
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--config", required=True, help="task or pretrain YAML")
    args = p.parse_args(argv)
    sd = to_torch(args.src, args.dst, args.config)
    print(f"wrote {len(sd)} tensors -> {args.dst}", flush=True)
    return sd


if __name__ == "__main__":
    main()
