"""ODVG dataset (jsonl), OD and VG modes: the port's own copy of the JAX
package's data/odvg.py (reference datasets/odvg.py:135-274).

OD mode (a label map is given): per sample, the caption is the positive
labels plus randomly sampled negative labels up to max_labels,
Fisher-Yates shuffled; instance labels index the shuffled caption list.
VG mode: region phrases, shuffled and deduplicated; the caption is their
join.  Sampling and augmentation draw from a per-index `random.Random`, the
JAX package's, so one seed gives both packages the same samples.
"""
from __future__ import annotations

import json
import os
import random
from typing import List, Optional

import numpy as np
from PIL import Image

from .transforms import Sample


class ODVGDataset:
    def __init__(self, root: str, anno: str, label_map_anno: Optional[str] = None,
                 max_labels: int = 80, transform=None, seed: int = 0):
        self.root = root
        self.dataset_mode = "OD" if label_map_anno else "VG"
        self.max_labels = max_labels
        self.transform = transform
        self.seed = seed
        if label_map_anno:
            with open(label_map_anno) as f:
                self.label_map = json.load(f)  # {id_str: name}
            self.label_index = set(self.label_map.keys())
        with open(anno) as f:
            self.metas = [json.loads(line) for line in f]

    def __len__(self) -> int:
        return len(self.metas)

    def __getitem__(self, index: int) -> Sample:
        # sampling is a pure function of (seed, index), whatever the order
        # in which loader threads ask for indices
        r = random.Random(self.seed * 0x9E3779B1 + index)
        meta = self.metas[index]
        image = Image.open(os.path.join(self.root, meta["filename"])).convert("RGB")
        w, h = image.size

        if self.dataset_mode == "OD":
            instances = meta["detection"]["instances"]
            boxes = [obj["bbox"] for obj in instances]
            ori_classes = [str(obj["label"]) for obj in instances]
            pos_labels = set(ori_classes)
            neg_labels = self.label_index.difference(pos_labels)

            vg_labels = list(pos_labels)
            num_to_add = min(len(neg_labels), self.max_labels - len(vg_labels))
            if num_to_add > 0:
                vg_labels.extend(r.sample(sorted(neg_labels), num_to_add))
            for i in range(len(vg_labels) - 1, 0, -1):   # Fisher-Yates (reference odvg.py:100-103)
                j = r.randint(0, i)
                vg_labels[i], vg_labels[j] = vg_labels[j], vg_labels[i]

            cap_list = [self.label_map[lb] for lb in vg_labels]
            cap_index = {name: i for i, name in enumerate(cap_list)}
            labels = [cap_index[self.label_map[c]] for c in ori_classes]
        else:
            regions = meta["grounding"]["regions"]
            pairs = [(obj["bbox"], obj["phrase"]) for obj in regions]
            r.shuffle(pairs)
            boxes = [b for b, _ in pairs]
            phrases = [p for _, p in pairs]
            cap_list = list(dict.fromkeys(phrases))  # dedup, stable
            cap_index = {p: i for i, p in enumerate(cap_list)}
            labels = [cap_index[p] for p in phrases]

        sample = Sample(
            image=image,
            boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int64),
            image_id=index,
            orig_size=(h, w),
            caption=" . ".join(cap_list) + " .",
            cap_list=cap_list,
        )
        if self.transform is not None:
            sample = self.transform(sample, rng=r)
        return sample


class ConcatDataset:
    def __init__(self, datasets: List):
        self.datasets = datasets
        self.offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        return self.datasets[d][idx - int(self.offsets[d])]
