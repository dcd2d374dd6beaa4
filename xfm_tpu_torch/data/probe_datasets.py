"""The linear-probe dataset registry (`xfm_tpu/data/probe_datasets.py`;
reference Imagenet.py:43-177, 328-434, the torchvision DATASETS of the
linear-eval table and its FER2013 h5 loader). Each name resolves to data
already on disk, in one of four layouts under `root`:

- a class-folder tree: <root>/<split>/<class_name>/<image>;
- a JSONL manifest: <root>/<split>.jsonl of {"image": path, "label": int};
- npz arrays: <root>/<split>.npz with `images` [N, H, W(, C)] uint8 and
  `labels` [N];
- FER2013's h5: <root>/<name>.h5 with <split>/images and <split>/labels.

A row is (path or uint8 array, label); `transforms.decode_image` takes
both. `h5py` is imported only inside the h5 loader.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ProbeSpec:
    num_classes: int
    train_split: str = "train"
    val_split: str = "val"
    kind: str = "auto"  # auto | h5 (the FER2013 layout whatever the files)


PROBE_DATASETS: dict[str, ProbeSpec] = {
    "imagenet": ProbeSpec(1000),
    "food101": ProbeSpec(101, val_split="test"),
    "cifar10": ProbeSpec(10, val_split="test"),
    "cifar100": ProbeSpec(100, val_split="test"),
    "cars": ProbeSpec(196, val_split="test"),
    "aircraft": ProbeSpec(100, val_split="test"),
    "dtd": ProbeSpec(47, val_split="test"),
    "pets": ProbeSpec(37, val_split="test"),
    "caltech101": ProbeSpec(101, val_split="test"),
    "flowers": ProbeSpec(102, val_split="test"),
    "mnist": ProbeSpec(10, val_split="test"),
    "fer2013": ProbeSpec(7, val_split="test", kind="h5"),
    "stl10": ProbeSpec(10, val_split="test"),
    "eurosat": ProbeSpec(10, val_split="test"),
    "resisc45": ProbeSpec(45, val_split="test"),
    "gtsrb": ProbeSpec(43, val_split="test"),
    "kitti": ProbeSpec(4, val_split="test"),
    "country211": ProbeSpec(211, val_split="test"),
    "pcam": ProbeSpec(2, val_split="test"),
    "sun397": ProbeSpec(397, val_split="test"),
    "svhn": ProbeSpec(10, val_split="test"),
    "renderedsst2": ProbeSpec(2, val_split="test"),
}


def load_probe_split(name: str, root: str, split: str):
    """→ (rows [(path or uint8 array, label)], num_classes), from the first
    layout found: h5, JSONL, npz, class folders."""
    spec = PROBE_DATASETS.get(name.lower())
    if spec is None:
        raise KeyError(f"unknown probe dataset {name!r}; known: "
                       f"{sorted(PROBE_DATASETS)}")
    h5 = os.path.join(root, f"{name}.h5")
    if spec.kind == "h5" or os.path.isfile(h5):
        return _load_h5(h5, split), spec.num_classes
    manifest = os.path.join(root, f"{split}.jsonl")
    if os.path.isfile(manifest):
        rows = []
        with open(manifest) as f:
            for line in f:
                d = json.loads(line)
                p = d["image"]
                rows.append((p if os.path.isabs(p) else os.path.join(root, p),
                             int(d["label"])))
        return rows, spec.num_classes
    npz = os.path.join(root, f"{split}.npz")
    if os.path.isfile(npz):
        with np.load(npz) as z:
            images, labels = z["images"], z["labels"]
        return [(images[i], int(labels[i])) for i in range(len(labels))], \
            spec.num_classes
    tree = os.path.join(root, split)
    if os.path.isdir(tree):
        classes = sorted(d for d in os.listdir(tree)
                         if os.path.isdir(os.path.join(tree, d)))
        rows = []
        for ci, c in enumerate(classes):
            cdir = os.path.join(tree, c)
            rows.extend((os.path.join(cdir, fn), ci)
                        for fn in sorted(os.listdir(cdir)))
        return rows, spec.num_classes
    raise FileNotFoundError(
        f"no {split}.jsonl / {split}.npz / {split}/ tree under {root} "
        f"for dataset {name!r}")


def _load_h5(path: str, split: str):
    """FER2013's h5: <split>/images uint8 [N, H, W(, C)] and <split>/labels
    [N] (or the two at the top level) → rows."""
    import h5py

    with h5py.File(path, "r") as f:
        grp = f[split] if split in f else f
        images = np.asarray(grp["images"])
        labels = np.asarray(grp["labels"])
    return [(images[i], int(labels[i])) for i in range(len(labels))]
