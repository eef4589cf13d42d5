"""Batch assembly and the input pipeline: the port's own copy of the JAX
package's data/loader.py.

`Collator` turns host-side Samples into the model's static-shape numpy
batch: bucket-padded images (uint8 in the u8_images mode, normalized on the
device by the train step), fixed-width tokenized captions with sub-sentence
masks, and GT padded to max_gt with per-GT token positive maps and a
validity mask (the reference's collate_fn/NestedTensor, util/misc.py:285-397,
plus the host half of its criterion, groundingdino.py:535-547).

`DataLoader` shuffles with a seed per epoch, takes its process's shard of
the order (`shard_iter`, DistributedSampler semantics, the JAX package's
order for each process), drops a short last batch when shuffling and pads it
to the static batch size otherwise, and collates in the calling thread or,
with num_threads > 0, in a small thread pool that keeps at most num_threads +
PREFETCH batches in flight.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Sequence

import numpy as np

from .tokenization import (
    BertWordPieceTokenizer,
    build_label_maps,
    generate_masks_with_special_tokens,
)
from .transforms import Bucketer, Sample, boxes_to_cxcywh_norm, normalize_image

PREFETCH = 2


class Collator:
    def __init__(self, tokenizer: BertWordPieceTokenizer, buckets: Sequence,
                 max_text_len: int = 256, max_gt: int = 128, u8_images: bool = False):
        self.tokenizer = tokenizer
        self.bucketer = Bucketer(buckets)
        self.max_text_len = max_text_len
        self.max_gt = max_gt
        self.special_ids = tokenizer.special_token_ids()
        self.u8_images = u8_images

    def __call__(self, samples: List[Sample]) -> Dict[str, np.ndarray]:
        B = len(samples)
        if self.u8_images:
            images = [np.asarray(s.image.convert("RGB"), np.uint8) for s in samples]
        else:
            images = [normalize_image(s.image) for s in samples]
        batch_images, image_sizes = self.bucketer.pad_batch(images)

        captions = [s.caption for s in samples]
        tok = self.tokenizer(captions, padding=self.max_text_len)
        attn_mask, position_ids = generate_masks_with_special_tokens(tok.input_ids,
                                                                     self.special_ids)
        label_maps = build_label_maps(tok, [s.cap_list for s in samples], captions,
                                      self.max_text_len)   # per sample (n_cats, T)

        G = self.max_gt
        gt_boxes = np.zeros((B, G, 4), np.float32)
        gt_pos_maps = np.zeros((B, G, self.max_text_len), np.float32)
        gt_valid = np.zeros((B, G), bool)
        for b, s in enumerate(samples):
            h, w = s.image.size[1], s.image.size[0]
            n = min(len(s.boxes), G)
            if n == 0:
                continue
            gt_boxes[b, :n] = boxes_to_cxcywh_norm(s.boxes[:n], h, w)
            gt_pos_maps[b, :n] = label_maps[b][s.labels[:n]]
            # a GT whose label found no tokens stays valid for the box
            # losses, as in the reference
            gt_valid[b, :n] = True

        return {
            "images": batch_images,
            "image_sizes": image_sizes,
            "input_ids": tok.input_ids,
            "text_token_mask": tok.attention_mask.astype(bool),
            "position_ids": position_ids.astype(np.int32),
            "text_self_attention_masks": attn_mask,
            "gt_boxes": gt_boxes,
            "gt_pos_maps": gt_pos_maps,
            "gt_valid": gt_valid,
            # eval metadata, host only: each image's (h, w) before the
            # transform, which the postprocess scales boxes to
            "image_ids": np.asarray([s.image_id for s in samples], np.int64),
            "orig_sizes": np.asarray([s.orig_size for s in samples], np.int64),
        }


def shard_iter(n: int, process_index: int, process_count: int, shuffle: bool, seed: int,
               drop_last: bool = True) -> List[int]:
    """Process `process_index`'s indices of a dataset of n, DistributedSampler
    semantics (the JAX package's data/loader.py:108-124): the order (a seeded
    permutation, or 0..n-1) padded by wrapping to a multiple of
    process_count, then strided.  `drop_last` is not used, as in the JAX
    package."""
    idx = np.arange(n)
    if shuffle:
        idx = np.random.RandomState(seed).permutation(n)
    if n % process_count != 0:
        pad = process_count - n % process_count
        idx = np.concatenate([idx, idx[:pad]])
    return idx[process_index::process_count].tolist()


class DataLoader:
    """Batches of one process's shard: `batch_size` is per process (the
    reference's per-GPU batch size), and len() counts this process's
    batches, which are the global batch's steps."""

    def __init__(self, dataset, collator: Collator, batch_size: int, shuffle: bool = False,
                 seed: int = 0, num_threads: int = 0, process_index: int = 0,
                 process_count: int = 1):
        self.dataset = dataset
        self.collator = collator
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = shuffle
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(shard_iter(len(self.dataset), self.process_index, self.process_count, False, 0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self):
        """[(dataset indices, n_real)]: full batches of this process's shard,
        then a last short batch padded with its own last index (dropped under
        drop_last unless it is the only one: a dataset smaller than one batch
        still trains)."""
        indices = shard_iter(len(self.dataset), self.process_index, self.process_count,
                             self.shuffle, self.seed + self.epoch)
        batches = []
        for i in range(0, len(indices), self.batch_size):
            b = indices[i : i + self.batch_size]
            if len(b) < self.batch_size:
                if self.drop_last and batches:
                    continue
                batches.append((b + [b[-1]] * (self.batch_size - len(b)), len(indices) - i))
            else:
                batches.append((b, self.batch_size))
        return batches

    def _collate(self, batch_idx: List[int], n_real: int) -> Dict:
        collated = self.collator([self.dataset[i] for i in batch_idx])
        collated["n_real"] = n_real
        return collated

    def __iter__(self) -> Iterator[Dict]:
        jobs = iter(self._batches())
        if self.num_threads <= 0:
            for job in jobs:
                yield self._collate(*job)
            return
        with ThreadPoolExecutor(self.num_threads) as pool:
            pending = deque()
            for _ in range(self.num_threads + PREFETCH):
                job = next(jobs, None)
                if job is None:
                    break
                pending.append(pool.submit(self._collate, *job))
            while pending:
                item = pending.popleft().result()
                job = next(jobs, None)
                if job is not None:
                    pending.append(pool.submit(self._collate, *job))
                yield item
