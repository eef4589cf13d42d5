"""The training and evaluation loops (the port of the JAX package's
engine.py::train_one_epoch and evaluate_coco; reference
engine_multi.py:353-949).

train_one_epoch: one train step per batch.  The loss and gradient norm reach
the host every step (the matcher synchronises anyway), so the abort on a
non-finite loss or a growing `nonfinite_count` (reference
engine_multi.py:544-547) is checked every step.

evaluate_coco: forward -> PostProcess -> numpy COCO mAP, pipelined one deep
as the JAX loop is: batch i+1's forward and device postprocess are launched
before batch i's host half runs.  Under a process group each rank evaluates
its shard of the val split, and the evaluator's records are gathered from
every rank before they are accumulated (the JAX package's
_merge_eval_across_hosts), so every rank holds the whole split's stats.
Progress lines go to the logger, which writes the console on rank 0 only.
"""
from __future__ import annotations

import datetime
import logging
import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .parallel import dist
from .utils.logger import MetricLogger, SmoothedValue

LOGGED_KEYS = ("loss", "loss_ce", "loss_bbox", "loss_giou", "grad_norm")


def train_one_epoch(train_step, state, loader, epoch: int,
                    logger: Optional[logging.Logger] = None, print_freq: int = 50,
                    max_steps: Optional[int] = None,
                    step_records: Optional[List[Dict]] = None):
    """One epoch; returns (state, {metric: global average over the epoch's
    steps}).  `step_records`, when given, receives every step's metrics and
    its host seconds (the step ends in a host read, so these are wall times
    of whole steps)."""
    meters = MetricLogger(logger=logger)
    # nonfinite_count is cumulative over the run: abort on growth since the
    # epoch began, not on its value
    base_nonfinite = state.nonfinite_count
    total = len(loader)
    t_epoch = time.perf_counter()
    t_data = time.perf_counter()
    for i, batch in enumerate(loader):
        data_s = time.perf_counter() - t_data
        t0 = time.perf_counter()
        metrics = train_step(state, batch)
        step_s = time.perf_counter() - t0
        if step_records is not None:
            step_records.append(dict(metrics, step_seconds=step_s, data_seconds=data_s))
        loss = metrics["loss"]
        if not math.isfinite(loss) or metrics["nonfinite_count"] > base_nonfinite:
            # the metrics are the global batch's: every rank stops here
            meters.print(f"Loss is {loss} (nonfinite steps: {metrics['nonfinite_count']}), "
                         f"stopping training: {metrics}")
            sys.exit(1)
        meters.update(**{k: metrics[k] for k in LOGGED_KEYS if k in metrics})
        if i % print_freq == 0 or i == total - 1:
            meters.print(f"Epoch [{epoch}] [{i}/{total}] {meters}  step_t: {step_s:.4f}  "
                         f"data_t: {data_s:.4f}")
        if max_steps is not None and i + 1 >= max_steps:
            break
        t_data = time.perf_counter()
    meters.print(f"Epoch [{epoch}] done in "
                 f"{datetime.timedelta(seconds=int(time.perf_counter() - t_epoch))}")
    return state, {k: m.global_avg for k, m in meters.meters.items()}


def merge_eval_records(evaluator) -> None:
    """Every rank's evaluator records (img_ids, eval_imgs) gathered into each
    rank's evaluator, in rank order (the JAX package's
    _merge_eval_across_hosts over all_gather_object).  An image that
    shard_iter's wrap evaluated twice keeps its first record, so every rank
    accumulates the same records; accumulate() counts each id once."""
    gathered = dist.all_gather_object((evaluator.img_ids, evaluator.eval_imgs))
    evaluator.img_ids = [i for ids, _ in gathered for i in ids]
    merged: Dict = {}
    for _, recs in gathered:
        for key, rec in recs.items():
            merged.setdefault(key, rec)
    evaluator.eval_imgs = merged


def evaluate_coco(eval_step, params: Dict, loader, postprocessor, coco_index,
                  contiguous_to_catid: Dict[int, int], logger: Optional[logging.Logger] = None,
                  print_freq: int = 50, max_steps: Optional[int] = None,
                  precast_dtype=None, use_native: bool = True) -> Dict[str, float]:
    """COCO bbox eval of `params` (name -> tensor, as make_eval_step's
    eval_step takes them); returns the 12 COCO stats.

    Pipelined one deep: batch i+1's eval_step and PostProcess.device are
    launched, and their copy to the host started, before batch i's host half
    (NMS, the label map, evaluator.update) runs, so on CUDA the host half
    overlaps the card's work.  `precast_dtype` casts the parameters once
    ahead of the pass (the JAX package's EVAL_PRECAST), which eval_step's own
    cast then leaves as they are.  The padded tail of the last batch
    (`n_real`) is not scored; labels go back to the dataset's category ids
    unless the postprocessor emits COCO ids.  A step with a criterion logs
    its mean loss.  `use_native`: the evaluator's C++ matcher (False: its
    numpy one).  Under a process group `loader` gives this rank's shard and
    the stats are the merged records' (merge_eval_records)."""
    from .eval.coco_eval import CocoBboxEvaluator
    from .parallel.train_state import cast_floating

    if precast_dtype is not None:
        with torch.no_grad():
            params = cast_floating(params, precast_dtype)
    evaluator = CocoBboxEvaluator(coco_index, use_native=use_native)
    loss_meter = SmoothedValue()
    emit = MetricLogger(logger=logger).print
    remap = not getattr(postprocessor, "emits_coco_ids", False)

    def finish(pending) -> None:
        batch, staged, loss = pending
        results = postprocessor.host(staged)
        n_real = batch.get("n_real", len(results))
        preds = {}
        for img_id, res in list(zip(batch["image_ids"].tolist(), results))[:n_real]:
            labels = res["labels"]
            if remap:
                labels = np.asarray([contiguous_to_catid.get(int(c), int(c)) for c in labels])
            preds[img_id] = {"scores": res["scores"], "labels": labels, "boxes": res["boxes"]}
        evaluator.update(preds)
        if loss is not None:
            loss_meter.update(float(loss))

    total = len(loader)
    t0 = time.perf_counter()
    pending = None
    for i, batch in enumerate(loader):
        out = eval_step(batch, params)
        staged = postprocessor.copy_to_host(postprocessor.device(out, batch["orig_sizes"]))
        if pending is not None:
            finish(pending)
        pending = (batch, staged, out.get("loss"))
        if i % print_freq == 0 or i == total - 1:
            emit(f"Eval [{i}/{total}]"
                 + (f"  loss: {loss_meter.median:.4f}" if loss_meter.count else ""))
        if max_steps is not None and i + 1 >= max_steps:
            break
    if pending is not None:
        finish(pending)
    if dist.world_size() > 1:
        merge_eval_records(evaluator)
    evaluator.accumulate()
    stats = evaluator.summarize()
    emit(f"Eval done in {time.perf_counter() - t0:.1f} s"
         + (f", loss {loss_meter.global_avg:.4f}" if loss_meter.count else "")
         + "; COCO bbox: " + " ".join(f"{k}={v:.4f}" for k, v in stats.items()))
    return stats
