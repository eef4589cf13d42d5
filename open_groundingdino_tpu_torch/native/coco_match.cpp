// Greedy per-category detection<->GT matching for COCO-style evaluation.
//
// Native replacement for the evaluator's hottest host loop
// (eval/coco_eval.py CocoBboxEvaluator._evaluate_img): for every IoU
// threshold, assign each detection (score-descending order assumed) to the
// best available GT, preferring non-ignored GT and allowing crowd GT to be
// matched repeatedly — pycocotools semantics.  The reference ships this
// logic inside pycocotools' C; this framework keeps the same split:
// Python orchestration, native inner loop.
//
// The port's own copy of the JAX package's native/coco_match.cpp.  Built at
// first use by utils/native.py (g++ -O3 -shared -fPIC into
// build/torch_native/libcoco_match.so); plain C ABI, called through ctypes.

#include <cstdint>

extern "C" {

// ious:      D*G row-major, IoU of det d vs gt g (crowd semantics upstream)
// gt_ignore: G flags (already sorted: non-ignored first)
// iscrowd:   G flags (same order)
// thrs:      T IoU thresholds
// dt_m:      out T*D, matched gt index or -1
// gt_m:      out T*G, matched det index or -1
// dt_ig_gt:  out T*D, 1 if matched to an ignored gt
void coco_greedy_match(const double* ious, const uint8_t* gt_ignore,
                       const uint8_t* iscrowd, const double* thrs,
                       int64_t D, int64_t G, int64_t T,
                       int64_t* dt_m, int64_t* gt_m, uint8_t* dt_ig_gt) {
  for (int64_t t = 0; t < T; ++t) {
    int64_t* dtm = dt_m + t * D;
    int64_t* gtm = gt_m + t * G;
    uint8_t* dig = dt_ig_gt + t * D;
    for (int64_t g = 0; g < G; ++g) gtm[g] = -1;
    double thr = thrs[t];
    double thr_eff = thr < (1.0 - 1e-10) ? thr : (1.0 - 1e-10);
    for (int64_t d = 0; d < D; ++d) {
      double best_iou = thr_eff;
      int64_t best_g = -1;
      const double* row = ious + d * G;
      for (int64_t g = 0; g < G; ++g) {
        // unavailable unless crowd
        if (gtm[g] >= 0 && !iscrowd[g]) continue;
        // once a real (non-ignored) match exists, stop at ignored GT
        // (gt are sorted non-ignored first)
        if (best_g >= 0 && !gt_ignore[best_g] && gt_ignore[g]) break;
        if (row[g] < best_iou) continue;
        best_iou = row[g];
        best_g = g;
      }
      dtm[d] = best_g;
      if (best_g >= 0) {
        gtm[best_g] = d;
        dig[d] = gt_ignore[best_g];
      } else {
        dig[d] = 0;
      }
    }
  }
}

}  // extern "C"
