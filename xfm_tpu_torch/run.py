"""The port's task launcher, with the CLI surface of the repository's
`run.py`:

    python3 -m xfm_tpu_torch.run --task T [--config C] [--model M]
        [--evaluate] [--output_dir O] [--checkpoint CKPT]
        [--load_ckpt_from CKPT] [--bs N] [--seed N] [--epoch N]
        [--device cuda|cpu]

Every task of that `run.py` is ported: retrieval (`itr_coco`,
`itr_flickr`: the fine-tune, with a zero-shot eval and then train, eval
and checkpoint each epoch, and with `--evaluate` the eval alone),
multi-stream pretraining (`pretrain_DIY`), VQA (`vqa`: the fine-tune,
checkpointing each epoch and ranking the test split's answers from
`start_eval` on and at the end, and with `--evaluate` the ranking alone),
COCO captioning (`coco_captioning`: the fine-tune with its beam-search
captions and scores, SCST where the YAML sets `scst`, the caption-domain
pretrain where it sets `domain_pretrain`, and with `--evaluate` the
captions and scores alone) and caption inference over a directory of
images (`infer_caption`), NLVR2 (`nlvr`: the fine-tune with its val and
test accuracies each epoch, and with `--evaluate` the test accuracy
alone), RefCOCO grounding (`refcoco_bbox`: the region-stream domain
pretrain at 224 px, then the bbox fine-tune at 384 px from its weights,
and with `--evaluate` the IoU ≥ 0.5 accuracy alone), ImageNet and the
linear probes (`imagenet`: the fine-tune with mixup / cutmix, or under
`is_lp` the frozen-tower probe with LARS, top-1 each epoch, and with
`--evaluate` the top-1 alone), GLUE (`glue`: the fine-tune with its
task's metrics each epoch, and with `--evaluate` the metrics alone) and
the generic text / image / image-text classifier (`classify`). Where
`--config` is missing or names no file, a task takes its default YAML
under configs/<--model>/ (`xfm-ft` by default; `pretrain_DIY` takes
configs/xfm-pt/Pretrain_XBrain_base_4m.yaml whatever the model), as the
repository's `run.py` falls back; `classify` has none and exits. `--bs`
is the global batch, divided over the processes into the YAML's train and
stream batch sizes (or its top-level `batch_size`, or GLUE's
`per_device_train_batch_size`). `--load_ckpt_from` is read as
`--checkpoint` by the caption tasks where no `--checkpoint` is given, and
by `refcoco_bbox` as stage 1's weights (stage 1 then does not run). Runs
on the card unless `--device cpu` is given.

Under `torchrun` the processes form one data-parallel group before the
task starts (`core/mesh.maybe_init_distributed`): NCCL with process i on
card `LOCAL_RANK` (`--device cuda` is read as "cuda:LOCAL_RANK"), gloo
with `--device cpu`; a launch that asks for a card where none is visible
raises. Every task runs on any number of processes, a step on W of
them equal to one process's step on the global batch (ImageNet's mixup
and cutmix aside, which pair rows within a rank) and an eval equal to
the one-process eval. `parallel: {data: D, fsdp: F, tensor: T}` with
D·F·T processes cuts every attention and MLP weight of the vision tower
(BEiT-2, CLIP-ViT, Swin or DeiT) and the text stacks over the T
consecutive ranks of each tensor group (Megatron pairs,
`ops/tensor_parallel`; the T ranks take the same rows, so `--bs` is
divided over D·F; `seq_shard: true` also shards the BEiT-2 tower's and
the text stacks' hidden states over the sequence between the pairs),
then shards every parameter, its gradient and its optimizer state over
the F ranks of each replica (`core/partitioning`, FSDP2; `data: -1`
takes the rest of the world size); `pipe` > 1 refuses
(`core/mesh.mesh_from_config`). At the end rank 0 prints the
backend, the world size and every rank's kernel launches (`###
processes ...`).
"""
from __future__ import annotations

import argparse
import importlib
import os


_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
# the YAMLs the tasks take where --config is missing or names no file, as
# the repository's run.py: under configs/<--model>/, pretrain_DIY's fixed
DEFAULT_CONFIGS = {
    "pretrain_DIY": os.path.join("xfm-pt", "Pretrain_XBrain_base_4m.yaml"),
    "glue": os.path.join("{model}", "glue_mrpc.yaml"),
    "imagenet": os.path.join("{model}", "imagenet1k.yaml"),
    "itr_coco": os.path.join("{model}", "Retrieval_coco.yaml"),
    "itr_flickr": os.path.join("{model}", "Retrieval_flickr.yaml"),
    "vqa": os.path.join("{model}", "VQA.yaml"),
    "coco_captioning": os.path.join("{model}", "Captioning.yaml"),
    "infer_caption": os.path.join("{model}", "Captioning.yaml"),
    "nlvr": os.path.join("{model}", "NLVR.yaml"),
    "refcoco_bbox": os.path.join("{model}", "Grounding_bbox.yaml"),
}


def resolve_config(args) -> str:
    """`--config` where it names a file, else the task's default YAML
    (`run.py` `resolve_config`); SystemExit for a task with none
    (`classify`) or a default that does not exist."""
    if args.config and os.path.exists(args.config):
        return args.config
    if args.task not in DEFAULT_CONFIGS:
        raise SystemExit(f"--config is required for task {args.task!r} "
                         "(no default config exists)")
    default = os.path.join(_CONFIGS,
                           DEFAULT_CONFIGS[args.task].format(model=args.model))
    if not os.path.exists(default):
        raise SystemExit(f"config {args.config!r} not found and the default "
                         f"{default!r} does not exist")
    if args.config:
        print(f"### config {args.config!r} not found, using default "
              f"{default}", flush=True)
    return default


# task → (its module under xfm_tpu_torch/tasks, the module's entry point)
TASKS = {"itr_coco": ("retrieval", "main"),
         "itr_flickr": ("retrieval", "main"),
         "pretrain_DIY": ("pretrain", "main"), "vqa": ("vqa", "main"),
         "coco_captioning": ("captioning", "main_pipeline"),
         "infer_caption": ("captioning", "main_infer"),
         "nlvr": ("nlvr", "main"),
         "refcoco_bbox": ("grounding", "main_bbox_pipeline"),
         "imagenet": ("imagenet", "main"), "glue": ("glue", "main"),
         "classify": ("classify", "main")}


def build_parser():
    p = argparse.ArgumentParser(description="xfm_tpu_torch task launcher")
    p.add_argument("--task", required=True, choices=sorted(TASKS))
    p.add_argument("--config", default="",
                   help="task YAML; where it is missing, the task's default "
                        "under configs/<--model>/ (every task but classify "
                        "has one)")
    p.add_argument("--model", default="xfm-ft",
                   help="the family of the default fine-tune YAMLs")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--load_ckpt_from", default=None,
                   help="the caption tasks: read as --checkpoint where none "
                        "is given; refcoco_bbox: stage 1's weights")
    p.add_argument("--evaluate", action="store_true",
                   help="run the eval only (no fine-tune)")
    p.add_argument("--bs", type=int, default=None,
                   help="global train batch size, divided over the "
                        "data x fsdp processes (the ranks of a "
                        "parallel.tensor group share rows)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dist", default="",
                   help="accepted as the repository's run.py accepts it; "
                        "the process group comes from torchrun's variables")
    p.add_argument("--master_port", type=int, default=None,
                   help="MASTER_PORT where torchrun's variables lack it")
    return p


def _report_processes() -> None:
    """Under a process group (a torchrun launch): every rank's kernel
    launches gathered to rank 0 (a collective of the backend, NCCL on the
    card), which prints them with the backend and the world size."""
    import json

    import torch.distributed as dist

    from .ops import kernels

    if not dist.is_initialized():
        return
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, launches)
    if dist.get_rank() == 0:
        print(f"### processes {dist.get_world_size()} backend "
              f"{dist.get_backend()} launches by rank {json.dumps(every)}",
              flush=True)


def main(argv=None):
    import torch.distributed as dist

    from .core import mesh

    args = build_parser().parse_args(argv)
    if args.master_port is not None:
        os.environ.setdefault("MASTER_PORT", str(args.master_port))
    owns_group = not dist.is_initialized()
    args.device = mesh.maybe_init_distributed(args.device)
    owns_group &= dist.is_initialized()
    try:
        args.config = resolve_config(args)
        os.makedirs(args.output_dir, exist_ok=True)
        module, entry = TASKS[args.task]
        task = importlib.import_module(f"xfm_tpu_torch.tasks.{module}")
        result = getattr(task, entry)(args)
        _report_processes()
    finally:
        if owns_group:
            dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
