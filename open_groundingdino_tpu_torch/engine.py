"""The training and evaluation loops (the port of the JAX package's
engine.py::train_one_epoch and evaluate_coco; reference
engine_multi.py:353-949).

train_one_epoch: one train step per batch, or with steps_per_call > 1 one
multi-step call per chunk of same-shape batches.  The steps read nothing
back (parallel/train_state.py): the metrics reach the host at the print_freq
cadence only, all the steps' since the last read in one copy, and there the
abort on a non-finite loss or a grown `nonfinite_count` (reference
engine_multi.py:544-547; the JAX package's _check_and_log) is checked.  The
steps in between were guarded on the device, so the parameters never took
a non-finite update.

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


def _shape_key(batch: Dict) -> tuple:
    return tuple(sorted((k, np.shape(v)) for k, v in batch.items()))


def _chunk_same_shape(loader, n: int):
    """Consecutive loader batches in lists of up to n with identical shapes
    (the JAX package's; static buckets make long runs of equal shapes the
    common case); a bucket switch flushes the current partial chunk."""
    chunk, key = [], None
    for batch in loader:
        k = _shape_key(batch)
        if chunk and (k != key or len(chunk) == n):
            yield chunk
            chunk = []
        chunk.append(batch)
        key = k
    if chunk:
        yield chunk


def stack_batches(batches: List[Dict]) -> Dict[str, np.ndarray]:
    """The model inputs and targets of same-shape batches stacked
    len(batches) deep: a multi-step call's batch."""
    from .parallel.train_state import MODEL_INPUT_KEYS, TARGET_KEYS

    return {k: np.stack([np.asarray(b[k]) for b in batches])
            for k in MODEL_INPUT_KEYS + TARGET_KEYS}


def metrics_to_host(steps: List[Dict[str, torch.Tensor]]) -> List[Dict[str, float]]:
    """Steps' device metrics as host numbers, in one copy."""
    keys = list(steps[0])
    values = torch.stack([torch.stack([m[k].float() for k in keys]) for m in steps]).tolist()
    return [{k: (int(x) if k == "nonfinite_count" else x) for k, x in zip(keys, row)}
            for row in values]


def train_one_epoch(train_step, state, loader, epoch: int,
                    logger: Optional[logging.Logger] = None, print_freq: int = 50,
                    max_steps: Optional[int] = None,
                    step_records: Optional[List[Dict]] = None,
                    multi_step=None, steps_per_call: int = 1):
    """One epoch; returns (state, {metric: global average over the epoch's
    steps}).  With steps_per_call > 1 and `multi_step`
    (make_multi_train_step(..., steps_per_call)), full chunks of same-shape
    batches go through multi_step, one call a chunk; partial chunks (the
    epoch's tail, bucket switches, the last steps before max_steps) go
    through train_step one batch at a time.  max_steps counts optimizer
    steps.

    The host reads the device at optimizer steps 0, print_freq, 2 print_freq,
    ... (a chunk that holds one of them is read after its call) and after the
    last step: there the steps since the last read are checked, fed to the
    meters and printed.  `step_records`, when given, receives every step's
    metrics (host numbers, filled in at those reads, which force nothing
    more) with its host seconds and its share of the wait for data: a step's
    seconds run from its call to its return, and to the end of the read that
    follows it; a chunk's are split evenly over its steps.  So at print_freq
    1 every step (every chunk) ends in a read and the records are wall times
    of whole steps (chunks); at a larger print_freq most are the host's
    queueing time alone."""
    meters = MetricLogger(logger=logger)
    # nonfinite_count is cumulative over the run: abort on growth since the
    # epoch began, not on its value
    base_nonfinite = int(state.nonfinite_count)
    total = len(loader)
    limit = total if max_steps is None else min(total, max_steps)
    use_multi = multi_step is not None and steps_per_call > 1
    chunks = _chunk_same_shape(loader, steps_per_call) if use_multi else ([b] for b in loader)
    pending: List[Dict] = []   # steps not read yet: device metrics and host seconds
    t_epoch = time.perf_counter()

    def read() -> None:
        """Every pending step's metrics to the host, in one copy; abort on a
        non-finite loss or a grown nonfinite_count; the meters."""
        for p, metrics in zip(pending, metrics_to_host([p["metrics"] for p in pending])):
            loss = metrics["loss"]
            if not math.isfinite(loss) or metrics["nonfinite_count"] > base_nonfinite:
                # the metrics are the global batch's: every rank stops here
                meters.print(f"Loss is {loss} (nonfinite steps: {metrics['nonfinite_count']}), "
                             f"stopping training: {metrics}")
                sys.exit(1)
            meters.update(**{k: metrics[k] for k in LOGGED_KEYS if k in metrics})
            p["metrics"] = metrics

    i = 0   # optimizer steps taken
    t_data = time.perf_counter()
    for chunk in chunks:
        data_s = time.perf_counter() - t_data
        if use_multi and len(chunk) == steps_per_call and i + len(chunk) <= limit:
            calls = [(len(chunk), lambda: multi_step(state, stack_batches(chunk)))]
        else:
            calls = [(1, lambda b=b: train_step(state, b)) for b in chunk[:limit - i]]
        for n, call in calls:
            t0 = time.perf_counter()
            out = call()
            new = [{"metrics": {k: v[j] for k, v in out.items()} if n > 1 else out,
                    "data_seconds": data_s / n} for j in range(n)]
            pending.extend(new)
            due = i + n >= limit or any((i + j) % print_freq == 0 for j in range(n))
            if due:
                read()
            for p in new:   # the read's wait belongs to the steps it waited for
                p["step_seconds"] = (time.perf_counter() - t0) / n
            if due:
                meters.print(f"Epoch [{epoch}] [{i + n - 1}/{total}] {meters}  step_t: "
                             f"{new[-1]['step_seconds']:.4f}  data_t: {data_s:.4f}")
                if step_records is not None:
                    step_records.extend(dict(p["metrics"], step_seconds=p["step_seconds"],
                                             data_seconds=p["data_seconds"]) for p in pending)
                pending.clear()
            i += n
            data_s = 0.0
        if i >= limit:
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
