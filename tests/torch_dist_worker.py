"""One rank of tests/test_torch_distributed.py's two-process gloo group.

Not a pytest file: the test starts one process a rank with torchrun's
variables (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), as

    python -m torch.distributed.run --nproc_per_node 2 tests/torch_dist_worker.py WORKDIR

would, and each rank reads WORKDIR/inputs.pkl (written by the test from numpy
seeds), runs the port on its share of the global batch and writes
WORKDIR/rank{R}.pkl.  Every check runs in the one group the worker joins
through the environment (the port's init_distributed); main keeps it.
  * "criterion": SetCriterion's total and losses on its rows of the fixed
    outputs, and again with the count reduction removed (per-rank
    num_boxes / num_pos);
  * "eval": the port's evaluator on its share of the synthetic predictions,
    the stats after merge_eval_records, and without the merge;
  * "steps": f32 train steps of the nano model on its row of each 2-image
    batch, per case (stochastic depth off for one step / on for two, and one
    step with the gradient reduction replaced by identity): losses, the
    first step's gradients and the parameters after;
  * "main": the port's main on the nano workspace (train one epoch with
    eval from datasets staged under --stage_dir, --device cpu, gloo): its
    records, stats, parameter digest and what staging returned; then main
    resumed from the checkpoint it wrote, and main --eval of that checkpoint.
"""
import os
import pickle
import sys
import types

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from open_groundingdino_tpu_torch.parallel import dist  # noqa: E402


def run_criterion(inp, rank):
    from open_groundingdino_tpu_torch.models import criterion

    rows = slice(rank, rank + 1)
    out = {"pred_logits": inp["logits"][0], "pred_boxes": inp["boxes"][0]}
    outputs = {k: torch.from_numpy(v[rows]) for k, v in out.items()}
    outputs["text_mask"] = torch.from_numpy(inp["text_mask"][rows])
    outputs["aux_outputs"] = [{"pred_logits": torch.from_numpy(inp["logits"][1][rows]),
                               "pred_boxes": torch.from_numpy(inp["boxes"][1][rows])}]
    outputs["interm_outputs"] = {"pred_logits": torch.from_numpy(inp["logits"][2][rows]),
                                 "pred_boxes": torch.from_numpy(inp["boxes"][2][rows])}
    targets = [torch.from_numpy(inp[k][rows]) for k in ("gt_boxes", "gt_pos_maps", "gt_valid")]
    crit = criterion.SetCriterion(num_queries=inp["num_queries"])

    def call():
        total, losses = crit(outputs, *targets)
        return float(total), {k: float(v) for k, v in losses.items()}

    result = {"global": call()}
    reduce = dist.all_reduce_sum_
    dist.all_reduce_sum_ = lambda tensors: None
    try:
        result["per_rank"] = call()
    finally:
        dist.all_reduce_sum_ = reduce
    return result


def run_eval(inp, rank, world):
    from open_groundingdino_tpu_torch.data.coco import CocoIndex
    from open_groundingdino_tpu_torch.data.loader import shard_iter
    from open_groundingdino_tpu_torch.engine import merge_eval_records
    from open_groundingdino_tpu_torch.eval.coco_eval import CocoBboxEvaluator

    index = CocoIndex(dataset=inp["dataset"])
    result = {}
    for case, ids in inp["cases"].items():
        mine = [ids[k] for k in shard_iter(len(ids), rank, world, False, 0)]
        stats = {}
        for merged in (True, False):
            ev = CocoBboxEvaluator(index, use_native=False)
            ev.update({i: inp["predictions"][i] for i in mine})
            if merged:
                merge_eval_records(ev)
            ev.accumulate()
            stats[merged] = ev.summarize()
        result[case] = {"merged": stats[True], "unmerged": stats[False], "ids": mine}
    return result


def nano_model(inp, droppath):
    """The nano detector from the port's seeded init, with chip_smoke's
    trained-like draws: small sampling-offset and attention-weight kernels
    and N(0, 0.02) biases (zero biases make the padded image's gradients
    overflow, ROADMAP section 3)."""
    from open_groundingdino_tpu_torch.models.bert import BertConfig
    from open_groundingdino_tpu_torch.models.deformable import MSDeformAttn
    from open_groundingdino_tpu_torch.models.groundingdino import GroundingDINO, init_weights_
    from open_groundingdino_tpu_torch.models.swin import SwinConfig

    model = init_weights_(GroundingDINO(SwinConfig(**inp["swin"]), BertConfig(**inp["bert"]),
                                        **inp["top"], fusion_droppath=droppath), 0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MSDeformAttn):
                for lin in (m.sampling_offsets, m.attention_weights):
                    lin.weight.normal_(0.0, 0.01, generator=g)
        for m in model.modules():
            if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)) and m.bias is not None:
                m.bias.normal_(0.0, 0.02, generator=g)
    return model


def two_steps(inp, droppath, steps, rows=slice(None), reduce=True):
    """`steps` (1 or 2) f32 train steps of nano_model on `rows` of each
    batch: the metrics, the first step's gradients (as the optimizer gets
    them) and the parameters after.  reduce=False replaces the gradient
    reduction by identity."""
    from open_groundingdino_tpu_torch.models.criterion import SetCriterion
    from open_groundingdino_tpu_torch.parallel import optim, train_state

    model = nano_model(inp, droppath)
    opt = optim.make_optimizer(model, base_lr=inp["opt"]["lr"], **inp["opt"])
    state = train_state.TrainState.create(model, opt, seed=0)
    grads, step_fn = [], opt.step

    def spy(g, norm, finite):
        if not grads:
            grads.append([t.clone().numpy() for t in g])
        step_fn(g, norm, finite)

    opt.step = spy
    step = train_state.make_train_step(SetCriterion(num_queries=inp["top"]["num_queries"]))
    saved = train_state.dist
    if not reduce:
        train_state.dist = types.SimpleNamespace(all_reduce_sum_=lambda tensors: None)
    try:
        metrics = [step(state, {k: v[rows] for k, v in b.items()})
                   for b in inp["batches"][:steps]]
    finally:
        train_state.dist = saved
    return {"metrics": metrics, "grads": grads[0], "names": opt.names,
            "params": {n: p.detach().numpy().copy() for n, p in model.named_parameters()}}


def run_steps(inp, rank):
    return {case: two_steps(inp, droppath, steps, slice(rank, rank + 1),
                            reduce=case != "no_reduction")
            for case, (droppath, steps) in inp["step_cases"].items()}


def run_main(ws):
    from open_groundingdino_tpu_torch import main as port_main
    from open_groundingdino_tpu_torch.data import staging

    def args(out, *extra):
        return port_main.get_args_parser().parse_args([
            "-c", ws["cfg"], "--datasets", ws["manifest"], "--output_dir", out, "--vocab",
            ws["vocab"], "--device", "cpu", *extra, "--options", "batch_size=2", "epochs=1",
            "compute_dtype=float32"])

    staged = []
    stage = staging.stage_datasets_for_node

    def spy_stage(*a, **kw):
        manifest, copies = stage(*a, **kw)
        staged.append({"paths": sorted(e[k] for entries in manifest.values() for e in entries
                                       for k in ("root", "anno") if e.get(k)),
                       "copies": copies})
        return manifest, copies

    staging.stage_datasets_for_node = spy_stage
    try:
        run = port_main.main(args(ws["out"], "--pretrain_model_path", ws["ckpt"], "--seed", "3",
                                  "--num_workers", "2", "--print_freq", "1", "--stage_dir",
                                  ws["stage"]))
    finally:
        staging.stage_datasets_for_node = stage
    trained = {"records": run["records"], "eval": run["eval"], "steps": len(run["loader"]),
               "staged": staged,
               "digest": dist.digest(p for _, p in run["state"].model.named_parameters())}
    # in the same group: training resumed from that checkpoint (its one epoch
    # done, so nothing more runs), then --eval of it
    ckpt = os.path.join(ws["out"], "checkpoint_0.pth")
    state = port_main.main(args(ws["resume_out"], "--resume", ckpt))["state"]
    trained["resumed"] = (state.step, dist.digest(p for _, p in state.model.named_parameters()))
    trained["eval_only"] = port_main.main(args(ws["eval_out"], "--pretrain_model_path", ckpt,
                                               "--num_workers", "0", "--eval"))["stats"]
    return trained


def main():
    work = sys.argv[1]
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    info = dist.init_distributed("cpu", timeout_s=120)
    rank, world = info.rank, info.world_size
    out = {"rank": rank, "world_size": world, "device": str(info.device),
           "criterion": run_criterion(inp["criterion"], rank),
           "eval": run_eval(inp["eval"], rank, world),
           "steps": run_steps(inp["steps"], rank),
           "main": run_main(inp["main"])}   # main keeps the group it finds
    dist.cleanup()
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
