"""A copy of ``tpu_syncbn.utils.fid`` (numpy only; the port imports nothing of the
JAX package), held equal to it by ``tests/test_torch_coco_fid.py``.

Fréchet (FID-style) distance between feature distributions.

The reference stack has no quantitative GAN evaluation (the recipe is a
104-line README; its GAN claim at ``README.md:3`` is qualitative). The
BASELINE GAN-stability config needs one anyway: loss trajectories are
chaos-dominated in adversarial training, so the sample-quality readout
that survives chaos is distributional — fit a Gaussian to features of
real and generated images under a FIXED extractor and take the Fréchet
distance, the construction behind FID (Heusel et al., 2017; public
method). Self-contained numpy (no scipy.linalg.sqrtm): the PSD matrix
square roots go through eigendecompositions with eigenvalue clipping.

Unlike canonical FID this makes no claim of comparability to published
numbers (those require the Inception-v3 extractor); it is a *relative*
instrument — same extractor, same reals, different arms.
"""

from __future__ import annotations

import numpy as np


def gaussian_stats(
    features: np.ndarray, shrinkage: float | str | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """(N, F) features -> (mean (F,), covariance (F, F)). N >= 2.

    ``shrinkage`` regularizes the sample covariance toward the scaled
    identity ``(tr(S)/F) I`` — essential when N is comparable to F (the
    A/B benchmarks fit F = 4*width features from ~dataset-size samples,
    where the raw estimator's noise can dominate small Fréchet gaps):

    * ``None`` (default): raw ``np.cov`` — bit-compatible with artifacts
      recorded before shrinkage existed.
    * a float in [0, 1]: fixed mixing weight gamma.
    * ``"oas"``: the Oracle Approximating Shrinkage weight (Chen,
      Wiesel & Hero, 2010 — closed form, public method), which adapts
      gamma to N/F automatically.
    """
    feats = np.asarray(features, np.float64)
    if feats.ndim != 2 or feats.shape[0] < 2:
        raise ValueError(
            f"need (N>=2, F) features, got shape {feats.shape}"
        )
    mu = feats.mean(0)
    cov = np.cov(feats, rowvar=False)
    cov = np.atleast_2d(cov)
    if shrinkage is None:
        return mu, cov
    n, f = feats.shape
    mu_tr = np.trace(cov) / f
    if shrinkage == "oas":
        tr_s2 = float((cov * cov).sum())  # tr(S @ S) for symmetric S
        tr_s_sq = float(np.trace(cov)) ** 2
        num = (1.0 - 2.0 / f) * tr_s2 + tr_s_sq
        den = (n + 1.0 - 2.0 / f) * (tr_s2 - tr_s_sq / f)
        gamma = 1.0 if den <= 0 else min(1.0, num / den)
    else:
        gamma = float(shrinkage)
        if not 0.0 <= gamma <= 1.0:
            raise ValueError(f"shrinkage must be in [0, 1], got {gamma}")
    return mu, (1.0 - gamma) * cov + gamma * mu_tr * np.eye(f)


def _sqrtm_psd(a: np.ndarray) -> np.ndarray:
    """Symmetric-PSD matrix square root via eigh; negative eigenvalues
    (numerical noise from rank-deficient sample covariances) clip to 0."""
    w, v = np.linalg.eigh((a + a.T) / 2.0)
    w = np.clip(w, 0.0, None)
    return (v * np.sqrt(w)) @ v.T


def frechet_distance(
    mu1: np.ndarray, cov1: np.ndarray, mu2: np.ndarray, cov2: np.ndarray
) -> float:
    """||mu1-mu2||^2 + tr(c1 + c2 - 2 (c1^1/2 c2 c1^1/2)^1/2).

    The trace term uses the symmetric similarity form so every matrix
    square root is of a (numerically) PSD symmetric matrix — no complex
    detours through sqrtm of the non-symmetric product c1 @ c2.
    """
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    s1 = _sqrtm_psd(np.asarray(cov1, np.float64))
    cross = _sqrtm_psd(s1 @ np.asarray(cov2, np.float64) @ s1)
    d2 = (
        float(((mu1 - mu2) ** 2).sum())
        + float(np.trace(cov1) + np.trace(cov2) - 2.0 * np.trace(cross))
    )
    # exact-zero case (identical stats) can land at tiny negative values
    return max(d2, 0.0)
