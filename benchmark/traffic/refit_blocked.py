"""The recovery re-fit of :mod:`benchmark.traffic.refit` at sizes whose
first steps one autograd graph of the reference cannot hold: the same
workload, with the reference's frames shaded and back-propagated in blocks
of the mix's ``block_pixels`` pixels
(:func:`benchmark.reference.train_blocked.steps_blocked`), and its targets
rendered by :func:`benchmark.reference.render.render`, which shades in
chunks. Mix parameters: ``refit``'s and ``block_pixels``.
"""

from __future__ import annotations

import torch

from benchmark.reference import render as R
from benchmark.reference import train_blocked as TB
from benchmark.traffic import refit


class Workload(refit.Workload):

    def reference(self, dtype=torch.float64) -> dict:
        """The reference's first steps from the same start, in ``dtype``,
        against its own renders of the targets in that dtype, in blocks."""
        n = int(self.mix["check_steps"])
        cams = self._ref_cameras(n)
        targets = [R.render(self.fields, c, self.depth, dtype) for c in cams]
        return TB.steps_blocked(self.raw0, targets, cams, self.depth,
                                self.mix["lr"], self.mix["lambda_dssim"], n,
                                dtype, int(self.mix["block_pixels"]))
