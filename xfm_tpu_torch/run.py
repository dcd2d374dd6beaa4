"""The port's task launcher, with the CLI surface of the repository's
`run.py`:

    python3 -m xfm_tpu_torch.run --task itr_coco --config C [--evaluate]
        [--output_dir O] [--checkpoint CKPT] [--bs N] [--seed N]
        [--epoch N] [--device cuda|cpu]
    python3 -m xfm_tpu_torch.run --task pretrain_DIY [--config C] ...

Of the tasks, retrieval (`itr_coco`, `itr_flickr`: the fine-tune, with a
zero-shot eval and then train, eval and checkpoint each epoch, and with
`--evaluate` the eval alone) and multi-stream pretraining
(`pretrain_DIY`; with no `--config`, or one that does not exist,
configs/xfm-pt/Pretrain_XBrain_base_4m.yaml, as the repository's `run.py`
falls back) are ported. Any other task is an argparse error that lists
the ported ones. `--bs` is the global batch, divided over the processes
into the YAML's train and stream batch sizes. Runs on the card unless
`--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os


def run_itr(args):
    from .tasks import retrieval

    return retrieval.main(args)


# the YAML pretrain_DIY takes with no --config, as the repository's run.py
PRETRAIN_DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
    "xfm-pt", "Pretrain_XBrain_base_4m.yaml")


def run_pretrain(args):
    from .tasks import pretrain

    if not (args.config and os.path.exists(args.config)):
        if args.config:
            print(f"### config {args.config!r} not found, using default "
                  f"{PRETRAIN_DEFAULT_CONFIG}", flush=True)
        args.config = PRETRAIN_DEFAULT_CONFIG
    return pretrain.main(args)


TASKS = {"itr_coco": run_itr, "itr_flickr": run_itr,
         "pretrain_DIY": run_pretrain}


def build_parser():
    p = argparse.ArgumentParser(description="xfm_tpu_torch task launcher")
    p.add_argument("--task", required=True, choices=sorted(TASKS))
    p.add_argument("--config", default="",
                   help="task YAML (pretrain_DIY has a default)")
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
    if args.task != "pretrain_DIY" and not args.config:
        parser.error(f"--config is required for task {args.task!r}")
    os.makedirs(args.output_dir, exist_ok=True)
    return TASKS[args.task](args)


if __name__ == "__main__":
    main()
