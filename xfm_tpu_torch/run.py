"""The port's task launcher, with the CLI surface of the repository's
`run.py`:

    python3 -m xfm_tpu_torch.run --task itr_coco --config C [--evaluate]
        [--output_dir O] [--checkpoint CKPT] [--bs N] [--seed N]
        [--epoch N] [--device cuda|cpu]
    python3 -m xfm_tpu_torch.run --task pretrain_DIY [--config C] ...
    python3 -m xfm_tpu_torch.run --task vqa [--config C] [--evaluate] ...
    python3 -m xfm_tpu_torch.run --task coco_captioning [--config C]
        [--evaluate] [--checkpoint CKPT | --load_ckpt_from CKPT] ...
    python3 -m xfm_tpu_torch.run --task infer_caption [--config C]
        [--checkpoint CKPT] ...
    python3 -m xfm_tpu_torch.run --task nlvr [--config C] [--evaluate] ...
    python3 -m xfm_tpu_torch.run --task refcoco_bbox [--config C]
        [--evaluate] [--checkpoint CKPT] [--load_ckpt_from CKPT] ...

Of the tasks, retrieval (`itr_coco`, `itr_flickr`: the fine-tune, with a
zero-shot eval and then train, eval and checkpoint each epoch, and with
`--evaluate` the eval alone), multi-stream pretraining (`pretrain_DIY`)
and VQA (`vqa`: the fine-tune, checkpointing each epoch and ranking the
test split's answers from `start_eval` on and at the end, and with
`--evaluate` the ranking alone), COCO captioning (`coco_captioning`: the
fine-tune with its beam-search captions and scores, SCST where the YAML
sets `scst`, the caption-domain pretrain where it sets `domain_pretrain`,
and with `--evaluate` the captions and scores alone) and caption
inference over a directory of images (`infer_caption`), NLVR2 (`nlvr`:
the fine-tune with its val and test accuracies each epoch, and with
`--evaluate` the test accuracy alone) and RefCOCO grounding
(`refcoco_bbox`: the region-stream domain pretrain at 224 px, then the
bbox fine-tune at 384 px from its weights, and with `--evaluate` the
IoU ≥ 0.5 accuracy alone) are ported. With no `--config`, or one that
does not exist, `pretrain_DIY` takes
configs/xfm-pt/Pretrain_XBrain_base_4m.yaml, `vqa`
configs/xfm-ft/VQA.yaml, the two caption tasks
configs/xfm-ft/Captioning.yaml, `nlvr` configs/xfm-ft/NLVR.yaml and
`refcoco_bbox` configs/xfm-ft/Grounding_bbox.yaml, as the repository's
`run.py` falls back.
Any other task is an argparse error that lists the ported ones. `--bs` is
the global batch, divided over the processes into the YAML's train and
stream batch sizes (or its top-level `batch_size`). `--load_ckpt_from` is
read as `--checkpoint` by the caption tasks where no `--checkpoint` is
given, and by `refcoco_bbox` as stage 1's weights (stage 1 then does not
run). Runs on the card unless `--device cpu` is given.
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
    "coco_captioning": os.path.join(_CONFIGS, "xfm-ft", "Captioning.yaml"),
    "infer_caption": os.path.join(_CONFIGS, "xfm-ft", "Captioning.yaml"),
    "nlvr": os.path.join(_CONFIGS, "xfm-ft", "NLVR.yaml"),
    "refcoco_bbox": os.path.join(_CONFIGS, "xfm-ft", "Grounding_bbox.yaml"),
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


def run_captioning(args):
    from .tasks import captioning

    _default_config(args)
    return captioning.main_pipeline(args)


def run_infer_caption(args):
    from .tasks import captioning

    _default_config(args)
    return captioning.main_infer(args)


def run_nlvr(args):
    from .tasks import nlvr

    _default_config(args)
    return nlvr.main(args)


def run_grounding(args):
    from .tasks import grounding

    _default_config(args)
    return grounding.main_bbox_pipeline(args)


TASKS = {"itr_coco": run_itr, "itr_flickr": run_itr,
         "pretrain_DIY": run_pretrain, "vqa": run_vqa,
         "coco_captioning": run_captioning,
         "infer_caption": run_infer_caption, "nlvr": run_nlvr,
         "refcoco_bbox": run_grounding}


def build_parser():
    p = argparse.ArgumentParser(description="xfm_tpu_torch task launcher")
    p.add_argument("--task", required=True, choices=sorted(TASKS))
    p.add_argument("--config", default="",
                   help="task YAML (pretrain_DIY, vqa, the caption tasks, "
                        "nlvr and refcoco_bbox have a default)")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--load_ckpt_from", default=None,
                   help="the caption tasks: read as --checkpoint where none "
                        "is given; refcoco_bbox: stage 1's weights")
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
