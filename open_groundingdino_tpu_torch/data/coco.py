"""COCO detection dataset and a minimal pure-Python COCO index: the port's
own copy of the JAX package's data/coco.py (reference datasets/coco.py:328-474).

pycocotools is not needed: the index gives the loadAnns / getCatIds surface
the data and eval layers use, and eval/coco_eval.py implements the COCOeval
mAP protocol in numpy.  Per image, crowd instances are dropped, xywh boxes
become xyxy clamped to the image, degenerate boxes are dropped; labels are
contiguous indices into the category list (`contiguous_to_catid` maps them
back), and the caption is the full category list.
"""
from __future__ import annotations

import json
import os
import random
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from .tokenization import build_caption
from .transforms import Sample


class CocoIndex:
    """Minimal COCO-annotation index (a subset of pycocotools.coco.COCO)."""

    def __init__(self, annotation_file: Optional[str] = None, dataset: Optional[dict] = None):
        if dataset is None:
            with open(annotation_file) as f:
                dataset = json.load(f)
        self.dataset = dataset
        self.imgs: Dict[int, dict] = {im["id"]: im for im in dataset.get("images", [])}
        self.cats: Dict[int, dict] = {c["id"]: c for c in dataset.get("categories", [])}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        self.anns: Dict[int, dict] = {}
        for ann in dataset.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)
            self.anns[ann["id"]] = ann

    def get_img_ids(self) -> List[int]:
        return sorted(self.imgs)

    def get_cat_ids(self) -> List[int]:
        return sorted(self.cats)

    def load_anns_for_img(self, img_id: int) -> List[dict]:
        return self.img_to_anns.get(img_id, [])

    def cat_names(self) -> List[str]:
        return [self.cats[c]["name"] for c in self.get_cat_ids()]


class CocoDetection:
    """Samples with labels as contiguous category indices (0..n_cats-1), so
    captions and positive maps line up."""

    def __init__(self, img_folder: str, ann_file: str, transform=None, seed: int = 0):
        self.root = img_folder
        self.seed = seed
        self.coco = CocoIndex(ann_file)
        self.ids = self.coco.get_img_ids()
        cat_ids = self.coco.get_cat_ids()
        self.catid_to_contiguous = {c: i for i, c in enumerate(cat_ids)}
        self.contiguous_to_catid = {i: c for c, i in self.catid_to_contiguous.items()}
        self.cat_list = self.coco.cat_names()
        self.transform = transform

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int) -> Sample:
        img_id = self.ids[idx]
        info = self.coco.imgs[img_id]
        img = Image.open(os.path.join(self.root, info["file_name"])).convert("RGB")
        w, h = img.size

        boxes, labels = [], []
        for ann in self.coco.load_anns_for_img(img_id):
            if ann.get("iscrowd", 0):
                continue
            x, y, bw, bh = ann["bbox"]
            x0, y0 = max(x, 0), max(y, 0)
            x1, y1 = min(x + bw, w), min(y + bh, h)
            if x1 <= x0 or y1 <= y0:
                continue
            boxes.append([x0, y0, x1, y1])
            labels.append(self.catid_to_contiguous[ann["category_id"]])

        sample = Sample(
            image=img,
            boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int64),
            image_id=img_id,
            orig_size=(h, w),
            # the caption of the full category list (reference
            # engine_multi.py:641-651): the same for every sample
            caption=build_caption(self.cat_list),
            cap_list=self.cat_list,
        )
        if self.transform is not None:
            sample = self.transform(sample, rng=random.Random(self.seed * 0x9E3779B1 + idx))
        return sample
