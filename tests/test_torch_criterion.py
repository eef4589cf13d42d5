"""The port's box ops, matcher and SetCriterion against the JAX package.

Box ops, the matching cost, the focal loss and the matched L1/GIoU losses
agree at abs 1e-5 / rel 1e-5 (f32).  The Hungarian assignment runs on the
host (scipy) in the port and on the device (Jonker-Volgenant) in the JAX
package; ties may resolve differently (ops/hungarian.py:60-61), so the two
are compared by total cost.  The minsum matcher is an argmin: equal indices.
The whole criterion (final, aux and interm sets) agrees at rel 1e-5 on
random outputs, where the assignment has no ties.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_groundingdino_tpu.models import criterion as jcrit
from open_groundingdino_tpu.models import matcher as jmatcher
from open_groundingdino_tpu.utils import box_ops as jbox
from open_groundingdino_tpu_torch.models import criterion, matcher
from open_groundingdino_tpu_torch.utils import box_ops

B, Q, G, T = 2, 30, 6, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _boxes(rng, *shape):
    """cxcywh boxes well inside the unit square."""
    c = rng.uniform(0.2, 0.8, shape + (2,))
    wh = rng.uniform(0.05, 0.4, shape + (2,))
    return np.concatenate([c, wh], -1).astype(np.float32)


def _outputs(seed):
    rng = np.random.RandomState(seed)
    text_mask = np.zeros((B, T), bool)
    text_mask[0, :11] = True
    text_mask[1, :7] = True
    logits = (rng.randn(B, Q, T) * 2).astype(np.float32)
    logits = np.where(text_mask[:, None, :], logits, -np.inf).astype(np.float32)
    boxes = _boxes(rng, B, Q)
    gt_boxes = _boxes(rng, B, G)
    gt_valid = np.zeros((B, G), bool)
    gt_valid[0, :4] = True
    gt_valid[1, :2] = True
    pos = np.zeros((B, G, T), np.float32)
    for b in range(B):
        for g in range(G):
            s = rng.randint(1, 5)
            pos[b, g, s : s + rng.randint(1, 3)] = 1.0
    return logits, boxes, gt_boxes, pos, gt_valid, text_mask


def test_box_ops_match_jax():
    rng = np.random.RandomState(0)
    a = jbox.box_cxcywh_to_xyxy(_boxes(rng, 3, 5))
    b = jbox.box_cxcywh_to_xyxy(_boxes(rng, 3, 7))
    e = jbox.box_cxcywh_to_xyxy(_boxes(rng, 3, 5))
    ta, tb, te = (torch.from_numpy(np.array(x)) for x in (a, b, e))
    pairs = [
        (box_ops.box_area(ta), jbox.box_area(a)),
        (box_ops.box_iou(ta, tb)[0], jbox.box_iou(a, b)[0]),
        (box_ops.box_iou(ta, tb)[1], jbox.box_iou(a, b)[1]),
        (box_ops.generalized_box_iou(ta, tb), jax.vmap(jbox.generalized_box_iou)(a, b)),
        (box_ops.box_iou_elementwise(ta, te)[0], jbox.box_iou_elementwise(a, e)[0]),
        (box_ops.generalized_box_iou_elementwise(ta, te),
         jbox.generalized_box_iou_elementwise(a, e)),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_cost_matrix_matches_jax():
    logits, boxes, gt_boxes, pos, gt_valid, _ = _outputs(1)
    ref = jmatcher.compute_cost_matrix(logits, boxes, gt_boxes, pos, gt_valid)
    ours = matcher.compute_cost_matrix(*map(torch.from_numpy, (logits, boxes, gt_boxes, pos,
                                                               gt_valid)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def _total_cost(cost, src, valid):
    return sum(cost[n, src[n, g], g] for n in range(cost.shape[0])
               for g in range(cost.shape[2]) if valid[n, g])


@pytest.mark.parametrize("seed", [2, 3])
def test_hungarian_total_cost_matches_jax(seed):
    logits, boxes, gt_boxes, pos, gt_valid, _ = _outputs(seed)
    cost = np.array(jmatcher.compute_cost_matrix(logits, boxes, gt_boxes, pos, gt_valid))
    # one tie: two identical query rows
    cost[0, 5] = cost[0, 4]
    ref = np.asarray(jax.jit(jmatcher.hungarian_assign)(jnp.asarray(cost), gt_valid))
    ours = matcher.hungarian_assign(torch.from_numpy(cost), torch.from_numpy(gt_valid)).numpy()
    assert ((ours == Q) == ~gt_valid).all()
    for n in range(B):   # injective on the valid GT
        live = ours[n][gt_valid[n]]
        assert len(set(live.tolist())) == len(live)
    np.testing.assert_allclose(_total_cost(cost, ours, gt_valid), _total_cost(cost, ref, gt_valid),
                               rtol=1e-6)


def test_minsum_matches_jax():
    logits, boxes, gt_boxes, pos, gt_valid, _ = _outputs(4)
    cost = np.asarray(jmatcher.compute_cost_matrix(logits, boxes, gt_boxes, pos, gt_valid))
    ref = np.asarray(jmatcher.minsum_assign(cost, gt_valid))
    ours = matcher.minsum_assign(torch.from_numpy(cost), torch.from_numpy(gt_valid)).numpy()
    np.testing.assert_array_equal(ours, ref)


def test_focal_and_box_losses_match_jax():
    logits, boxes, gt_boxes, pos, gt_valid, text_mask = _outputs(5)
    rng = np.random.RandomState(5)
    src = np.stack([rng.permutation(Q)[:G] for _ in range(B)]).astype(np.int32)
    src = np.where(gt_valid, src, Q).astype(np.int32)
    one_hot_j = jcrit.build_one_hot_targets(src, pos, gt_valid, Q)
    one_hot = criterion.build_one_hot_targets(torch.from_numpy(src).long(), torch.from_numpy(pos),
                                              torch.from_numpy(gt_valid), Q)
    np.testing.assert_array_equal(one_hot.numpy(), np.asarray(one_hot_j))
    num = 3.0
    ref = jcrit.token_sigmoid_focal_loss(logits, one_hot_j, text_mask, num, 0.25, 2.0)
    ours = criterion.token_sigmoid_focal_loss(torch.from_numpy(logits), one_hot,
                                              torch.from_numpy(text_mask), num, 0.25, 2.0)
    np.testing.assert_allclose(float(ours), float(ref), **TOL)
    ref = jcrit._matched_box_losses(boxes, src, gt_boxes, gt_valid, num)
    ours = criterion.matched_box_losses(torch.from_numpy(boxes), torch.from_numpy(src).long(),
                                        torch.from_numpy(gt_boxes), torch.from_numpy(gt_valid), num)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(float(o), float(r), **TOL)


@pytest.mark.parametrize("matcher_type", ["HungarianMatcher", "SimpleMinsumMatcher"])
def test_set_criterion_matches_jax(matcher_type):
    sets = [_outputs(10 + i) for i in range(3)]
    text_mask = sets[0][5]
    _, _, gt_boxes, pos, gt_valid, _ = sets[0]

    def out_dict(conv):
        main = {"pred_logits": conv(sets[0][0]), "pred_boxes": conv(sets[0][1])}
        return {**main, "text_mask": conv(text_mask),
                "aux_outputs": [{"pred_logits": conv(sets[1][0]), "pred_boxes": conv(sets[1][1])}],
                "interm_outputs": {"pred_logits": conv(sets[2][0]),
                                   "pred_boxes": conv(sets[2][1])}}

    kw = dict(num_queries=Q, matcher_type=matcher_type)
    total_j, losses_j = jcrit.SetCriterion(**kw)(out_dict(jnp.asarray), gt_boxes, pos, gt_valid)
    total, losses = criterion.SetCriterion(**kw)(
        out_dict(torch.from_numpy), *map(torch.from_numpy, (gt_boxes, pos, gt_valid)))
    assert set(losses) == set(losses_j)
    for k in losses:
        np.testing.assert_allclose(float(losses[k]), float(losses_j[k]), **TOL, err_msg=k)
    np.testing.assert_allclose(float(total), float(total_j), **TOL)
