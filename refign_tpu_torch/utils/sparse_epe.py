"""SparseEPE / PCK / AUSE metric, host-side numpy (a copy of
``refign_tpu/utils/sparse_epe.py``, which the port may not import).

Reproduces the reference torchmetrics SparseEPE
(helpers/metrics.py:35-261): dense predicted flow sampled at ROUNDED target
correspondence points, per-sample AEPE averaged over samples, PCK counts
normalized by total valid correspondences, and the AUSE sparsification AUC
for the uncertainty estimate.  Ragged per-sample correspondences make this a
natural host computation (no static shapes needed); distributed reduction is
a plain sum of the accumulator dict (:meth:`SparseEPE.reduce`: one
``all_reduce`` of the accumulators packed in one float64 tensor).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..parallel import mesh


class SparseEPE:
    def __init__(self, uncertainty_estimation: bool = False, **kwargs):
        self.uncertainty_estimation = uncertainty_estimation
        self.reset()

    def reset(self):
        self.AEPE = 0.0
        self.PCK = {1: 0.0, 3: 0.0, 5: 0.0, 10: 0.0}
        self.nbr_valid_corr = 0
        self.nbr_samples = 0
        self.AUSE_AEPE = 0.0

    def update(self, t_s_flow: np.ndarray, corr_pts_s: List[np.ndarray],
               corr_pts_t: List[np.ndarray], out_size: Sequence[int],
               uncertainty_est: Optional[np.ndarray] = None):
        """t_s_flow: (B, H, W, 2) target->source flow (channel-last);
        uncertainty_est: (B, H, W, 1)."""
        h, w = out_size
        assert t_s_flow.shape[1:3] == (h, w)
        for bb in range(t_s_flow.shape[0]):
            x_s, y_s = corr_pts_s[bb][:, 0], corr_pts_s[bb][:, 1]
            x_t, y_t = corr_pts_t[bb][:, 0], corr_pts_t[bb][:, 1]
            valid = ((np.round(x_s) >= 0) & (np.round(x_s) < w)
                     & (np.round(y_s) >= 0) & (np.round(y_s) < h)
                     & (np.round(x_t) >= 0) & (np.round(x_t) < w)
                     & (np.round(y_t) >= 0) & (np.round(y_t) < h))
            n = int(valid.sum())
            if n == 0:
                continue
            x_s, y_s = x_s[valid], y_s[valid]
            x_t, y_t = x_t[valid], y_t[valid]
            iy = np.round(y_t).astype(int)
            ix = np.round(x_t).astype(int)
            flow_gt = np.stack([x_s - x_t, y_s - y_t], 1)
            flow_est = t_s_flow[bb, iy, ix, :2]
            epe = np.linalg.norm(flow_gt - flow_est, axis=1)
            self.AEPE += float(epe.mean())
            for t in self.PCK:
                self.PCK[t] += float(np.sum(epe <= t))
            self.nbr_valid_corr += n
            self.nbr_samples += 1
            if self.uncertainty_estimation:
                if uncertainty_est is None:
                    # the reference fails loudly here (indexing None);
                    # silently skipping would deflate AUSE_AEPE while
                    # nbr_samples keeps counting
                    raise ValueError(
                        "SparseEPE(uncertainty_estimation=True) requires "
                        "uncertainty_est in update()")
                uncert = uncertainty_est[bb, iy, ix, 0]
                self.AUSE_AEPE += self._ause(flow_gt, flow_est, uncert)

    def _packed(self) -> List[float]:
        return ([self.AEPE] + [self.PCK[t] for t in sorted(self.PCK)]
                + [self.nbr_valid_corr, self.nbr_samples, self.AUSE_AEPE])

    def reduce(self) -> None:
        """Sum the accumulators over the ranks, in place (one collective
        of a float64 tensor on this process's device; the counts stay
        exact); nothing without a process group."""
        if not torch.distributed.is_initialized():
            return
        t = mesh.all_reduce_sum(torch.tensor(
            self._packed(), dtype=torch.float64,
            device=mesh.process_device()))
        vals = t.cpu().tolist()
        self.AEPE = vals[0]
        for i, k in enumerate(sorted(self.PCK)):
            self.PCK[k] = vals[1 + i]
        n = 1 + len(self.PCK)
        self.nbr_valid_corr = int(vals[n])
        self.nbr_samples = int(vals[n + 1])
        self.AUSE_AEPE = vals[n + 2]

    @staticmethod
    def _ause(gt, pred, uncert, intervals: int = 50) -> float:
        """Sparsification AUC (reference metrics.py:135-201)."""
        epe = np.linalg.norm(gt - pred, axis=1)
        neg_u = -uncert
        neg_e = -epe
        quants = [t / intervals for t in range(intervals)]
        plotx = np.array([t / intervals for t in range(intervals + 1)])

        def curve(scores):
            thr = [np.quantile(scores, q) for q in quants]
            vals = []
            for t in thr:
                sub = scores >= t
                vals.append(epe[sub].mean() if sub.any() else 0.0)
            vals.append(0.0)
            return np.array(vals)

        sparse_c = curve(neg_u)
        opt_c = curve(neg_e)
        mmax = opt_c.max() + 1e-6
        trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy<2
        return float(abs(trapezoid(sparse_c / mmax, plotx)
                         - trapezoid(opt_c / mmax, plotx)))

    def compute(self) -> Dict[str, float]:
        ns = max(self.nbr_samples, 1)
        nc = max(self.nbr_valid_corr, 1)
        out = {"AEPE": self.AEPE / ns}
        for t, v in self.PCK.items():
            out[f"PCK_{t}"] = v / nc
        if self.uncertainty_estimation:
            out["AUSE_AEPE"] = self.AUSE_AEPE / ns
        return out
