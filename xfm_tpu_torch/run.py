"""The port's task launcher, with the CLI surface of the repository's
`run.py`:

    python3 -m xfm_tpu_torch.run --task itr_coco --config C [--evaluate]
        [--output_dir O] [--checkpoint CKPT] [--bs N] [--seed N]
        [--epoch N] [--device cuda|cpu]
    python3 -m xfm_tpu_torch.run --task pretrain_DIY [--config C] ...
    python3 -m xfm_tpu_torch.run --task vqa [--config C] [--evaluate] ...

Of the tasks, retrieval (`itr_coco`, `itr_flickr`: the fine-tune, with a
zero-shot eval and then train, eval and checkpoint each epoch, and with
`--evaluate` the eval alone), multi-stream pretraining (`pretrain_DIY`)
and VQA (`vqa`: the fine-tune, checkpointing each epoch and ranking the
test split's answers from `start_eval` on and at the end, and with
`--evaluate` the ranking alone) are ported. With no `--config`, or one
that does not exist, `pretrain_DIY` takes
configs/xfm-pt/Pretrain_XBrain_base_4m.yaml and `vqa`
configs/xfm-ft/VQA.yaml, as the repository's `run.py` falls back. Any
other task is an argparse error that lists the ported ones. `--bs` is
the global batch, divided over the processes into the YAML's train and
stream batch sizes. Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os


def run_itr(args):
    from .tasks import retrieval

    return retrieval.main(args)


_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
# the YAMLs the tasks take with no --config, as the repository's run.py
DEFAULT_CONFIGS = {
    "pretrain_DIY": os.path.join(_CONFIGS, "xfm-pt",
                                 "Pretrain_XBrain_base_4m.yaml"),
    "vqa": os.path.join(_CONFIGS, "xfm-ft", "VQA.yaml"),
}


def _default_config(args) -> None:
    if not (args.config and os.path.exists(args.config)):
        default = DEFAULT_CONFIGS[args.task]
        if args.config:
            print(f"### config {args.config!r} not found, using default "
                  f"{default}", flush=True)
        args.config = default


def run_pretrain(args):
    from .tasks import pretrain

    _default_config(args)
    return pretrain.main(args)


def run_vqa(args):
    from .tasks import vqa

    _default_config(args)
    return vqa.main(args)


TASKS = {"itr_coco": run_itr, "itr_flickr": run_itr,
         "pretrain_DIY": run_pretrain, "vqa": run_vqa}


def build_parser():
    p = argparse.ArgumentParser(description="xfm_tpu_torch task launcher")
    p.add_argument("--task", required=True, choices=sorted(TASKS))
    p.add_argument("--config", default="",
                   help="task YAML (pretrain_DIY and vqa have a default)")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--evaluate", action="store_true",
                   help="run the eval only (no fine-tune)")
    p.add_argument("--bs", type=int, default=None,
                   help="global train batch size, divided over the "
                        "processes")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.task not in DEFAULT_CONFIGS and not args.config:
        parser.error(f"--config is required for task {args.task!r}")
    os.makedirs(args.output_dir, exist_ok=True)
    return TASKS[args.task](args)


if __name__ == "__main__":
    main()
