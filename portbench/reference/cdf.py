"""Flow-size distributions (paper §6: Web Search, Facebook Hadoop,
Alibaba Storage), as piecewise-linear CDFs.

The breakpoints follow the CDF files shipped with the DCQCN/HPCC
simulation artifacts (traffic_gen/flowCDF in the paper's own repo);
values are the standard published curves re-entered from the literature
(DCTCP for WebSearch, Roy et al. for FB Hadoop, HPCC for AliStorage).
Sampling inverts the CDF with linear interpolation in log-size space.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class SizeCDF:
    name: str
    sizes: np.ndarray   # bytes, increasing
    probs: np.ndarray   # cdf in [0,1], increasing, ends at 1

    def mean(self) -> float:
        """Exact mean of the sampled distribution: within a CDF segment
        the size is log-linear in u (see ``sample``), so the conditional
        mean is the *logarithmic* mean of the endpoints,
        ``(s1 - s0) / ln(s1/s0)`` — not the arithmetic midpoint, which
        belongs to linear-size interpolation and overstates every
        segment. Load calibration divides by this, so the two must agree
        or every "x% load" run is silently mis-dosed."""
        s0, s1 = self.sizes[:-1], self.sizes[1:]
        w = np.diff(self.probs)
        with np.errstate(divide="ignore", invalid="ignore"):
            logmean = np.where(np.isclose(s0, s1), s0,
                               (s1 - s0) / np.log(s1 / s0))
        return float((logmean * w).sum() + self.sizes[0] * self.probs[0])

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Invert the CDF with linear interpolation in log-size space.

        The published breakpoints are log-spaced samples of smooth
        heavy-tailed curves; linear-size interpolation within a segment
        like [1 MB, 10 MB) puts half the segment's mass above 5.5 MB
        (the tail draws bias large), where the curves' own log-linear
        shape puts the median near the geometric mean ~3.2 MB."""
        u = rng.uniform(0, 1, n)
        return np.exp(np.interp(u, self.probs, np.log(self.sizes)))


WEB_SEARCH = SizeCDF(
    "WebSearch",
    sizes=np.array([1e3, 2e3, 3e3, 5e3, 7e3, 1e4, 2e4, 3e4, 5e4, 8e4,
                    2e5, 1e6, 2e6, 5e6, 1e7, 3e7], float),
    probs=np.array([0.00, 0.15, 0.30, 0.40, 0.53, 0.60, 0.70, 0.72, 0.82,
                    0.87, 0.91, 0.95, 0.97, 0.99, 0.997, 1.0], float),
)

FB_HADOOP = SizeCDF(
    "FbHdp",
    sizes=np.array([1e2, 2e2, 3.5e2, 5e2, 1e3, 2e3, 5e3, 1e4, 4e4,
                    1e5, 1e6, 1e7], float),
    probs=np.array([0.00, 0.20, 0.40, 0.50, 0.60, 0.70, 0.78, 0.82, 0.87,
                    0.90, 0.95, 1.0], float),
)

ALI_STORAGE = SizeCDF(
    "AliStorage",
    sizes=np.array([2e2, 1e3, 4e3, 1.6e4, 6.4e4, 2.56e5, 1e6, 4e6,
                    1.6e7, 6.4e7], float),
    probs=np.array([0.00, 0.30, 0.50, 0.60, 0.70, 0.80, 0.90, 0.95,
                    0.99, 1.0], float),
)

WORKLOADS: Dict[str, SizeCDF] = {
    "websearch": WEB_SEARCH,
    "fbhdp": FB_HADOOP,
    "alistorage": ALI_STORAGE,
}
