"""The port's multi-process data parallelism (parallel/dist.py and its callers)
against the JAX package and against the port's own one-process step, on the
CPU over gloo.

One launch of two ranks (tests/torch_dist_worker.py, with the environment
torchrun gives its processes) serves the file; each runs under a timeout and
is killed with its process group on it.  Held:
  * the port's shard_iter equals the JAX package's, and each rank's
    DataLoader batches and length follow it as the JAX loader's do;
  * the 2-rank eval merge (merge_eval_records) gives the JAX package's
    single-process CocoBboxEvaluator stats on the whole set at atol 1e-9,
    also where shard_iter's wrap evaluates an image twice; without the merge
    the stats move;
  * the 2 ranks' SetCriterion totals, on fixed outputs with 1 and 4 GT,
    sum to the JAX SetCriterion's on the global batch at rtol 1e-5, loss by
    loss; with per-rank num_boxes / num_pos they do not;
  * the 2-rank f32 train step, one image a rank, against the
    port's 1-rank step on the 2-image batch (itself held against the JAX step
    by tests/test_torch_train_step.py), on a nano model with small random
    biases (torch_dist_worker.nano_model): losses at rtol 1e-5, the first
    step's gradients within 1e-5 of each tensor's largest |grad| plus 1e-6
    of the largest overall (one batched backward against two summed), the
    parameters at rtol 1e-5 / atol 2e-6 (Adam's g / sqrt(v) magnifies
    rounding where |g| is tiny; a parameter whose gradient is zero up to
    rounding within 4 lr), one step with the fusion's stochastic depth off
    and two at 0.5 (every rank draws the global batch's masks and keeps its
    row);
    the ranks' parameters are equal bit for bit; with the gradient reduction
    replaced by identity the comparison fails;
  * main on 2 ranks (--device cpu, gloo) trains an epoch of a nano config
    and evaluates it, on datasets staged under --stage_dir: both ranks log
    the same global losses and stats and end with the same parameters, rank
    0 alone writes log.txt, the checkpoint (best/ a hard link to it) and
    config_cfg.py, both write info.txt, rank 0 alone copies the datasets,
    both read the copies, and the copies are gone after; then, in the same
    group, main resumed from that checkpoint (both ranks at its step and
    parameters) and main --eval of it: the same stats on both ranks, and
    rank 0's eval_stats.json;
  * utils/logger.setup_logger gives the JAX package's handlers: the console
    on process 0 only, info.txt from every process.
"""
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import chip_smoke
import jax
import jax.numpy as jnp
import torch_dist_worker
import two_process_eval_worker as jeval_worker
from open_groundingdino_tpu.data import loader as jloader
from open_groundingdino_tpu.eval.coco_eval import CocoBboxEvaluator as JCocoBboxEvaluator
from open_groundingdino_tpu.models import criterion as jcrit
from open_groundingdino_tpu_torch.data import loader
from test_torch_evaluate import NANO_CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
WORLD = 2
TIMEOUT_S = 240
RANK_THREADS = 2

# the step's nano geometry (tests/test_torch_train_step.py's at 1 + 1 layers)
B, T, QN, G, IMG = 2, 16, 12, 3, 96
SWIN = dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 4), window_size=4,
            out_indices=(1, 2, 3))
BERT = dict(vocab_size=40, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
            intermediate_size=32, max_position_embeddings=32)
TOP = dict(hidden_dim=32, num_queries=QN, nheads=4, num_feature_levels=4, enc_layers=1,
           dec_layers=1, dim_feedforward=64, max_text_len=T)
OPT = dict(lr=1e-4, lr_backbone=1e-5, lr_linear_proj_mult=0.1, weight_decay=1e-4,
           clip_max_norm=0.1)
# (fusion drop-path rate, steps): the second step is held with stochastic
# depth on; without the reduction one step already parts the runs
STEP_CASES = {"droppath_off": (0.0, 1), "droppath_on": (0.5, 2), "no_reduction": (0.0, 1)}
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-6
PARAM_RTOL, PARAM_ATOL = 1e-5, 2e-6
NOISE_STEPS = 4   # two steps, each of at most lr, on either side
EVAL_CASES = {"even": list(range(jeval_worker.N_IMGS)),
              "wrap": list(range(jeval_worker.N_IMGS - 1))}   # rank 1 also takes image 0


def _batch(seed):
    """Two images of one canvas (the second padded: valid 80x72), a
    two-phrase caption with 10 live tokens, three GT slots of which the
    second image uses one."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, 40, size=(B, T)).astype(np.int32)
    ids[:, 0], ids[:, 9] = 2, 3
    sam = np.tile(np.eye(T, dtype=bool)[None], (B, 1, 1))
    sam[:, 1:5, 1:5] = True
    sam[:, 5:9, 5:9] = True
    pos = np.zeros((B, T), np.int32)
    pos[:, 1:5] = np.arange(4)
    pos[:, 5:9] = np.arange(4)
    pos_maps = np.zeros((B, G, T), np.float32)
    pos_maps[:, 0, 1:3] = 1.0
    pos_maps[:, 1, 5:7] = 1.0
    pos_maps[:, 2, 3:5] = 1.0
    gt_valid = np.ones((B, G), bool)
    gt_valid[1, 1:] = False
    return {
        "images": rng.randint(0, 256, (B, IMG, IMG, 3)).astype(np.uint8),
        "image_sizes": np.asarray([[IMG, IMG], [80, 72]], np.int32),
        "input_ids": ids,
        "text_token_mask": np.tile(np.arange(T)[None] < 10, (B, 1)),
        "position_ids": pos,
        "text_self_attention_masks": sam,
        "gt_boxes": (rng.uniform(0.3, 0.7, (B, G, 4)) * [1, 1, 0.4, 0.4]).astype(np.float32),
        "gt_pos_maps": pos_maps,
        "gt_valid": gt_valid,
    }


def _criterion_inputs(seed=5, q=30, g=6, t=16):
    """Three output sets (final, aux, interm) of a 2-image batch whose
    images hold 1 and 4 GT, logits small enough for the JAX matcher's
    eager cost (tests/test_torch_criterion.py)."""
    rng = np.random.RandomState(seed)
    text_mask = np.zeros((B, t), bool)
    text_mask[0, :11] = True
    text_mask[1, :7] = True

    def boxes(*shape):
        return np.concatenate([rng.uniform(0.2, 0.8, shape + (2,)),
                               rng.uniform(0.05, 0.4, shape + (2,))], -1).astype(np.float32)

    logits = [np.where(text_mask[:, None, :], rng.randn(B, q, t) * 2, -np.inf).astype(np.float32)
              for _ in range(3)]
    gt_valid = np.zeros((B, g), bool)
    gt_valid[0, :1] = True
    gt_valid[1, :4] = True
    pos = np.zeros((B, g, t), np.float32)
    for b in range(B):
        for k in range(g):
            s = rng.randint(1, 5)
            pos[b, k, s:s + rng.randint(1, 3)] = 1.0
    return {"logits": logits, "boxes": [boxes(B, q) for _ in range(3)], "text_mask": text_mask,
            "gt_boxes": boxes(B, g), "gt_pos_maps": pos, "gt_valid": gt_valid, "num_queries": q}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results (tests/torch_dist_worker.py), the 1-rank
    references and the nano workspace of the main run."""
    work = str(tmp_path_factory.mktemp("dist"))
    ws = {"cfg": os.path.join(work, "cfg.py"), "vocab": os.path.join(work, "vocab.txt"),
          "ckpt": os.path.join(work, "ckpt.pth"), "out": os.path.join(work, "out"),
          "eval_out": os.path.join(work, "eval_out"), "resume_out": os.path.join(work, "resume_out"),
          "stage": os.path.join(work, "stage")}
    with open(ws["cfg"], "w") as f:
        f.write(NANO_CFG)
    chip_smoke.write_vocab(ws["vocab"], 200)
    chip_smoke.write_checkpoint(ws["cfg"], ws["ckpt"], random_biases=True)
    chip_smoke.write_odvg(work)
    ws["manifest"] = chip_smoke.write_coco_val(work)
    index = jeval_worker.make_index()
    inputs = {
        "criterion": _criterion_inputs(),
        "eval": {"dataset": index.dataset, "predictions": jeval_worker.make_predictions(),
                 "cases": EVAL_CASES},
        "steps": {"swin": SWIN, "bert": BERT, "top": TOP, "opt": OPT,
                  "step_cases": STEP_CASES, "batches": [_batch(0), _batch(1)]},
        "main": ws,
    }
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONHASHSEED="0", OMP_NUM_THREADS=str(RANK_THREADS), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(WORLD))
    # the variables torchrun sets, without its agent process (4 s of start-up)
    procs = [subprocess.Popen([sys.executable, WORKER, work], cwd=REPO,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              start_new_session=True)
             for r in range(WORLD)]
    threads = torch.get_num_threads()
    try:
        # the references, while the ranks run, on as many threads as a rank
        # (more contend with the ranks' and slow all three down tenfold)
        torch.set_num_threads(RANK_THREADS)
        refs = {case: torch_dist_worker.two_steps(inputs["steps"], dp, n)
                for case, (dp, n) in STEP_CASES.items() if case != "no_reduction"}
        refs["criterion"] = _jax_criterion(inputs["criterion"])
        deadline = time.monotonic() + TIMEOUT_S
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))[0] for p in procs]
    except BaseException:
        for p in procs:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
        raise
    finally:
        torch.set_num_threads(threads)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-6000:]
    results = []
    for r in range(WORLD):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return {"ranks": results, "refs": refs, "inputs": inputs, "ws": ws}


@pytest.mark.parametrize("n,count,shuffle,seed", [
    (8, 1, True, 0), (8, 2, True, 3), (9, 2, True, 3), (10, 4, True, 7),
    (7, 3, False, 0), (5, 4, False, 0), (3, 4, True, 1), (1, 2, False, 0)])
def test_shard_iter_matches_jax(n, count, shuffle, seed):
    for r in range(count):
        assert loader.shard_iter(n, r, count, shuffle, seed) == \
            jloader.shard_iter(n, r, count, shuffle, seed)


@pytest.mark.parametrize("n,batch,shuffle", [(9, 2, True), (9, 2, False), (3, 2, True)])
def test_loader_shards_match_jax(n, batch, shuffle):
    """Each rank's batches are its shard of the epoch's order, chunked and
    padded as the JAX loader does (data/loader.py:170-184), and its length
    the JAX loader's."""
    for r in range(WORLD):
        kw = dict(batch_size=batch, shuffle=shuffle, seed=4, process_index=r,
                  process_count=WORLD)
        port = loader.DataLoader(list(range(n)), None, **kw)
        port.set_epoch(2)
        assert len(port) == len(jloader.DataLoader(list(range(n)), None, **kw))
        order = jloader.shard_iter(n, r, WORLD, shuffle, 4 + 2)
        want = []
        for i in range(0, len(order), batch):
            b = order[i:i + batch]
            if len(b) < batch:
                if shuffle and want:   # drop_last follows shuffle
                    continue
                want.append((b + [b[-1]] * (batch - len(b)), len(order) - i))
            else:
                want.append((b, batch))
        assert port._batches() == want


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_eval_merge_matches_jax(ranks, case):
    ids = EVAL_CASES[case]
    preds = jeval_worker.make_predictions()
    ref_ev = JCocoBboxEvaluator(jeval_worker.make_index(), use_native=False)
    ref_ev.update({i: preds[i] for i in ids})
    ref_ev.accumulate()
    ref = ref_ev.summarize()
    assert 0.0 < ref["AP"] < 1.0
    covered = sorted(i for res in ranks["ranks"] for i in res["eval"][case]["ids"])
    assert sorted(set(covered)) == ids and len(covered) == len(ids) + len(ids) % WORLD
    for res in ranks["ranks"]:
        got = res["eval"][case]
        assert set(got["merged"]) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got["merged"][k], ref[k], atol=1e-9, err_msg=k)
        # the merge has teeth: one rank's half alone moves the stats
        assert max(abs(got["unmerged"][k] - ref[k]) for k in ref) > 1e-3


def _jax_criterion(inp):
    """The JAX SetCriterion on the global batch, jitted (eagerly its
    Hungarian solver runs op by op: 15 s against 2 s)."""
    def sets(conv):
        return {"pred_logits": conv(inp["logits"][0]), "pred_boxes": conv(inp["boxes"][0]),
                "text_mask": conv(inp["text_mask"]),
                "aux_outputs": [{"pred_logits": conv(inp["logits"][1]),
                                 "pred_boxes": conv(inp["boxes"][1])}],
                "interm_outputs": {"pred_logits": conv(inp["logits"][2]),
                                   "pred_boxes": conv(inp["boxes"][2])}}

    crit = jcrit.SetCriterion(num_queries=inp["num_queries"])
    total, losses = jax.jit(crit)(sets(jnp.asarray), inp["gt_boxes"], inp["gt_pos_maps"],
                                  inp["gt_valid"])
    return float(total), {k: float(v) for k, v in losses.items()}


def test_criterion_shares_sum_to_jax_global(ranks):
    total_j, losses_j = ranks["refs"]["criterion"]

    def summed(kind):
        per = [res["criterion"][kind] for res in ranks["ranks"]]
        return sum(t for t, _ in per), {k: sum(ls[k] for _, ls in per) for k in per[0][1]}

    total, losses = summed("global")
    assert set(losses) == set(losses_j)
    for k in losses:
        np.testing.assert_allclose(losses[k], losses_j[k], rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(total, total_j, rtol=LOSS_RTOL)
    # per-rank normalisers (1 and 4 boxes) give another total
    per_rank_total, _ = summed("per_rank")
    assert abs(per_rank_total - total_j) > 1e-2 * abs(total_j)


def _step_gaps(got, ref) -> dict:
    """The largest gaps of the losses (against LOSS_RTOL), the first step's
    gradients (GRAD_RTOL of each tensor's max plus GRAD_FLOOR of the overall
    max) and the parameters (assert_allclose's PARAM_RTOL / PARAM_ATOL), each
    as a multiple of its limit.  A parameter whose gradient is zero up to
    rounding (within the floor: the BERT key bias, which softmax ignores)
    takes Adam steps of up to lr on noise whose sign the two runs may not
    share, so it is held to NOISE_STEPS x lr instead."""
    loss = max(abs(g["loss"] - r["loss"]) / abs(r["loss"])   # over got's steps
               for g, r in zip(got["metrics"], ref["metrics"])) / LOSS_RTOL
    floor = GRAD_FLOOR * max(float(np.abs(g).max()) for g in ref["grads"])
    grad = max(float(np.abs(g - r).max()) / (GRAD_RTOL * float(np.abs(r).max()) + floor)
               for g, r in zip(got["grads"], ref["grads"]))
    noise = {n for n, g in zip(ref["names"], ref["grads"]) if float(np.abs(g).max()) <= floor}
    param = max(float((np.abs(got["params"][n] - r) / (
        NOISE_STEPS * OPT["lr"] if n in noise else PARAM_ATOL + PARAM_RTOL * np.abs(r))).max())
        for n, r in ref["params"].items())
    return {"loss": loss, "grad": grad, "param": param}


@pytest.mark.parametrize("case", ["droppath_off", "droppath_on"])
def test_two_rank_step_equals_one_rank(ranks, case):
    ref = ranks["refs"][case]
    first, second = (res["steps"][case] for res in ranks["ranks"])
    for n, p in first["params"].items():   # the ranks are replicas
        assert np.array_equal(p, second["params"][n]), n
    assert first["metrics"] == second["metrics"]
    gaps = _step_gaps(first, ref)
    assert max(gaps.values()) <= 1.0, gaps
    if case == "droppath_on":
        # the masks the step drew differ between the two images somewhere,
        # so a per-rank draw (both ranks taking row 0) would part the runs
        g = torch.Generator().manual_seed(0)
        keep = [(torch.rand(B, generator=g) < 0.5).tolist() for _ in range(4)]
        assert any(a != b for a, b in keep), keep


def test_step_without_reduction_fails(ranks):
    """One step with the gradient reduction replaced by identity (the
    worker stops there): its loss and gradients fail the comparison with the
    1-rank run's first step, and the ranks' parameters part."""
    ref = ranks["refs"]["droppath_off"]
    runs = [res["steps"]["no_reduction"] for res in ranks["ranks"]]
    for run in runs:
        gaps = _step_gaps(run, ref)
        assert gaps["loss"] > 1.0 and gaps["grad"] > 1.0, gaps
    assert any(not np.array_equal(p, runs[1]["params"][n]) for n, p in runs[0]["params"].items())


def test_main_on_two_ranks(ranks):
    ws = ranks["ws"]
    first, second = (res["main"] for res in ranks["ranks"])
    assert [(r["rank"], r["world_size"], r["device"]) for r in ranks["ranks"]] == \
        [(0, WORLD, "cpu"), (1, WORLD, "cpu")]
    # 8 images, 2 a rank: 2 global steps of 4, the same metrics on each rank
    assert first["steps"] == second["steps"] == 2 == len(first["records"])
    keys = ("loss", "loss_ce", "loss_bbox", "loss_giou", "grad_norm")
    for a, b in zip(first["records"], second["records"]):
        assert all(np.isfinite(a[k]) and a[k] == b[k] for k in keys)
    assert first["digest"] == second["digest"]
    assert first["eval"] == second["eval"] and len(first["eval"]) == 1
    assert all(np.isfinite(v) for v in first["eval"][0].values())
    out = ws["out"]
    assert {"checkpoint_0.pth", "config_cfg.py", "info.txt", "log.txt"} <= set(os.listdir(out))
    with open(os.path.join(out, "log.txt")) as f:
        assert len(f.read().splitlines()) == 1   # rank 0 alone appends
    # best/ of the epoch just saved is that file, linked
    assert os.path.samefile(os.path.join(out, "best", "checkpoint_0.pth"),
                            os.path.join(out, "checkpoint_0.pth"))
    with open(os.path.join(out, "info.txt")) as f:
        info = f.read()
    assert "rank 0 of 2 (gloo)" in info and "rank 1 of 2 (gloo)" in info
    # --stage_dir: rank 0 alone copied, both ranks read the copies, and they
    # are gone once main returns
    (staged0,), (staged1,) = first["staged"], second["staged"]
    assert staged0["copies"] and staged1["copies"] == []
    assert staged0["paths"] == staged1["paths"]
    assert all(p.startswith(ws["stage"] + os.sep) for p in staged0["paths"])
    assert os.listdir(ws["stage"]) == []
    # both ranks resumed from the one checkpoint: its step and parameters
    assert first["resumed"] == second["resumed"] == (2, first["digest"])
    # main --eval of that checkpoint in the same group: the merged stats on
    # both ranks, eval_stats.json from rank 0
    assert first["eval_only"] == second["eval_only"]
    assert sorted(os.listdir(ws["eval_out"])) == ["config_cfg.py", "eval_stats.json", "info.txt"]
    with open(os.path.join(ws["eval_out"], "eval_stats.json")) as f:
        assert json.load(f) == first["eval_only"]


@pytest.mark.parametrize("process_index", [0, 1])
def test_logger_console_on_process_zero(tmp_path, process_index):
    """utils/logger.setup_logger as the JAX package's: the console on
    process 0 only, info.txt from every process."""
    from open_groundingdino_tpu.utils.logger import setup_logger as jsetup_logger
    from open_groundingdino_tpu_torch.utils.logger import setup_logger

    kinds = []
    for fn, name, sub in ((setup_logger, f"ogd_torch_test{process_index}", "port"),
                          (jsetup_logger, f"ogd_tpu_test{process_index}", "jax")):
        logger = fn(str(tmp_path / sub), name=name, process_index=process_index)
        logger.info("a line")
        kinds.append(sorted(type(h).__name__ for h in logger.handlers))
        for h in logger.handlers:
            h.flush()
        assert "a line" in (tmp_path / sub / "info.txt").read_text()
    assert kinds[0] == kinds[1]
    assert ("StreamHandler" in kinds[0]) == (process_index == 0)
