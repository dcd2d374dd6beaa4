"""REFER annotations (`xfm_tpu/eval/refer.py`, reference
refTools/refer_python3.py): the refcoco / refcoco+ / refcocog refs pickle
and instances json, the split / ref / box lookups the grounding eval needs,
the rows `GroundingData` reads, and the IoU@0.5 accuracy of pixel boxes.
"""
from __future__ import annotations

import json
import os
import pickle
from collections import defaultdict


class REFER:
    def __init__(self, data_root: str, dataset: str = "refcoco+",
                 split_by: str = "unc"):
        ref_file = os.path.join(data_root, dataset,
                                f"refs({split_by}).p")
        inst_file = os.path.join(data_root, dataset, "instances.json")
        with open(ref_file, "rb") as f:
            self.refs = pickle.load(f)
        with open(inst_file) as f:
            instances = json.load(f)
        self.anns = {a["id"]: a for a in instances["annotations"]}
        self.imgs = {i["id"]: i for i in instances["images"]}
        self.ref_by_id = {r["ref_id"]: r for r in self.refs}
        self.refs_by_split = defaultdict(list)
        for r in self.refs:
            self.refs_by_split[r["split"]].append(r)

    def get_refs(self, split: str):
        return self.refs_by_split[split]

    def ref_box(self, ref_id: int):
        """→ [x, y, w, h] gt box of a ref."""
        ref = self.ref_by_id[ref_id]
        return self.anns[ref["ann_id"]]["bbox"]

    def ref_image(self, ref_id: int):
        ref = self.ref_by_id[ref_id]
        return self.imgs[ref["image_id"]]

    def to_grounding_json(self, split: str):
        """→ [{image, text, bbox, ref_id}], one row a sentence, in the
        format `data.finetune_data.GroundingData` reads."""
        rows = []
        for ref in self.get_refs(split):
            img = self.imgs[ref["image_id"]]
            bbox = self.anns[ref["ann_id"]]["bbox"]
            for sent in ref["sentences"]:
                rows.append({"image": img["file_name"],
                             "text": sent["sent"] if "sent" in sent
                             else sent.get("raw", ""),
                             "bbox": bbox, "ref_id": ref["ref_id"]})
        return rows


def grounding_eval_from_results(results, refer: REFER, thresh: float = 0.5):
    """The share of results [{'ref_id', 'pred_xyxy_pixels'}] whose box has
    IoU ≥ `thresh` with its ref's box."""
    import numpy as np

    correct = total = 0
    for r in results:
        x, y, w, h = refer.ref_box(r["ref_id"])
        gt = np.asarray([x, y, x + w, y + h], np.float32)
        p = np.asarray(r["pred_xyxy_pixels"], np.float32)
        lt = np.maximum(p[:2], gt[:2])
        rb = np.minimum(p[2:], gt[2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[0] * wh[1]
        union = ((p[2] - p[0]) * (p[3] - p[1])
                 + (gt[2] - gt[0]) * (gt[3] - gt[1]) - inter)
        if union > 0 and inter / union >= thresh:
            correct += 1
        total += 1
    return correct / max(total, 1)
