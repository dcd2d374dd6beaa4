"""The port's task launcher, with the CLI surface of the repository's
`run.py`:

    python3 -m xfm_tpu_torch.run --task itr_coco --config C [--evaluate]
        [--output_dir O] [--checkpoint CKPT] [--bs N] [--seed N]
        [--epoch N] [--device cuda|cpu]

Of the tasks only retrieval is ported (`itr_coco`, `itr_flickr`): the
fine-tune (zero-shot eval, then train, eval and checkpoint each epoch) and,
with `--evaluate`, the eval alone. Any other task is an argparse error that
lists the ported ones. Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os


def run_itr(args):
    from .tasks import retrieval

    return retrieval.main(args)


TASKS = {"itr_coco": run_itr, "itr_flickr": run_itr}


def build_parser():
    p = argparse.ArgumentParser(description="xfm_tpu_torch task launcher")
    p.add_argument("--task", required=True, choices=sorted(TASKS))
    p.add_argument("--config", required=True, help="task YAML")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--evaluate", action="store_true",
                   help="run the eval only (no fine-tune)")
    p.add_argument("--bs", type=int, default=None,
                   help="global train batch size (one device a process)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    return TASKS[args.task](args)


if __name__ == "__main__":
    main()
