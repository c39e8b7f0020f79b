// Fast COCO evaluation — native matching + accumulation kernels.
//
// The port's copy of cocodet_tpu/layers/fast_coco_eval/src/cocoeval.cpp,
// unchanged below this note, bound by cocodet_tpu_torch/evaluators/
// fast_coco_eval.py; its python twin, the plain version the tests hold it
// against, is cocodet_tpu_torch/evaluators/coco_metric.py::match_image.
//
// Role parity: ref yolox/layers/csrc/cocoeval/cocoeval.cpp (the pybind11
// COCOevalEvaluateImages/COCOevalAccumulate extension, SURVEY.md §2.5).
// This implementation is written fresh against the COCO protocol and is
// exposed through a plain C ABI consumed via ctypes (this image has no
// pybind11); the python twin lives in
// cocodet_tpu/evaluators/coco_metric.py and is the correctness oracle.
//
// match_image: greedy per-image detection->GT matching at T IoU thresholds.
//   ious:      (nd, ng) row-major, dets sorted by score desc, gts sorted
//              ignore-last.
//   gt_ignore: (ng,) 0/1 — crowd or out-of-area GTs.
//   gt_crowd:  (ng,) 0/1 — crowd GTs may be matched repeatedly.
//   out dt_match: (nt, nd) matched gt index or -1.
//   out dt_ignore: (nt, nd) 0/1.
//
// accumulate_pr: given score-sorted matched/ignored flags, computes the
//   101-point interpolated precision array and final recall for one
//   (iou_thr, category, area, maxdet) cell.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

void match_image(const double* ious, int nd, int ng,
                 const uint8_t* gt_ignore, const uint8_t* gt_crowd,
                 const double* iou_thrs, int nt,
                 int64_t* dt_match, uint8_t* dt_ignore) {
  std::vector<uint8_t> gt_taken(static_cast<size_t>(ng));
  for (int ti = 0; ti < nt; ++ti) {
    std::fill(gt_taken.begin(), gt_taken.end(), 0);
    const double t = iou_thrs[ti];
    int64_t* match_row = dt_match + static_cast<size_t>(ti) * nd;
    uint8_t* ignore_row = dt_ignore + static_cast<size_t>(ti) * nd;
    for (int di = 0; di < nd; ++di) {
      double best_iou = t < (1.0 - 1e-10) ? t : (1.0 - 1e-10);
      int best_g = -1;
      const double* iou_row = ious + static_cast<size_t>(di) * ng;
      for (int gi = 0; gi < ng; ++gi) {
        if (gt_taken[gi] && !gt_crowd[gi]) continue;
        // gts sorted ignore-last: once a real match exists, stop at ignores
        if (best_g >= 0 && !gt_ignore[best_g] && gt_ignore[gi]) break;
        if (iou_row[gi] < best_iou) continue;
        best_iou = iou_row[gi];
        best_g = gi;
      }
      match_row[di] = best_g;
      ignore_row[di] = best_g >= 0 ? gt_ignore[best_g] : 0;
      if (best_g >= 0) gt_taken[best_g] = 1;
    }
  }
}

// Precision envelope sampled at r_n recall points.
//   matched/ignored: (nd,) flags in score order; npig: #non-ignored GTs.
//   out precision: (r_n,), out recall: scalar.
void accumulate_pr(const uint8_t* matched, const uint8_t* ignored, int nd,
                   long long npig, const double* recall_thrs, int r_n,
                   double* precision_out, double* recall_out) {
  std::vector<double> rc(nd), pr(nd);
  double tp = 0.0, fp = 0.0;
  for (int i = 0; i < nd; ++i) {
    if (!ignored[i]) {
      if (matched[i]) tp += 1.0; else fp += 1.0;
    }
    rc[i] = npig > 0 ? tp / static_cast<double>(npig) : 0.0;
    const double denom = tp + fp;
    pr[i] = denom > 0 ? tp / denom : 0.0;
  }
  *recall_out = nd > 0 ? rc[nd - 1] : 0.0;
  // monotone envelope from the right
  for (int i = nd - 2; i >= 0; --i) pr[i] = std::max(pr[i], pr[i + 1]);
  // sample at recall thresholds (searchsorted left)
  for (int k = 0; k < r_n; ++k) {
    const double* it =
        std::lower_bound(rc.data(), rc.data() + nd, recall_thrs[k]);
    const long long idx = it - rc.data();
    precision_out[k] = idx < nd ? pr[idx] : 0.0;
  }
}

}  // extern "C"
