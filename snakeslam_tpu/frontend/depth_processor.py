"""Depth-map preprocessing: hysteresis outlier rejection + edge-aware blur.

Parity with the reference's ``DepthProcessor2`` (saiga DepthmapPreprocessor),
used for RGB-D input — constructed with ``{dont_care, gauss_radius,
hyst_min, hyst_max}`` and a stereo camera model, and run over every frame's
depth image (reference: Snake/System/System.cpp:226-241, and the per-KF
variant sketched at Snake/LocalMapping/LocalMapping.cpp:53-68 with
gauss_radius=4, hyst_min=7, hyst_max=9).

The reference implementation is a serial CPU scan; this one is a stack of
fixed-shape convolutions so XLA can fuse the whole filter into a couple of
passes over device memory:

1. **Noise model** — structured-light / stereo depth quantization grows
   quadratically with depth: one disparity step at depth ``z`` spans
   ``dz = z^2 / (fx * b)``.  All thresholds are multiples of this local
   step size, so the filter adapts to near/far geometry automatically.
2. **Hysteresis edge rejection** — pixels whose minimum absolute depth
   difference to any 8-neighbour exceeds ``hyst_max * dz`` are flying
   pixels (no surface support) and are cleared.  Pixels in the weak band
   ``(hyst_min, hyst_max] * dz`` survive only when 4-connected to a
   strong (confident) pixel, found by a few dilation iterations.
3. **Edge-aware Gaussian** — a ``(2r+1)^2`` Gaussian whose taps are
   masked to neighbours within ``hyst_min * dz`` of the centre depth and
   renormalized, so surfaces smooth but depth discontinuities stay sharp.

Invalid input (``<= dont_care``) stays invalid (0).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


def _shift(img: jax.Array, dy: int, dx: int, fill: float) -> jax.Array:
    """Shift a 2-D image by (dy, dx), filling vacated pixels."""
    out = jnp.roll(img, (dy, dx), axis=(0, 1))
    H, W = img.shape
    if dy > 0:
        out = out.at[:dy, :].set(fill)
    elif dy < 0:
        out = out.at[dy:, :].set(fill)
    if dx > 0:
        out = out.at[:, :dx].set(fill)
    elif dx < 0:
        out = out.at[:, dx:].set(fill)
    return out


@functools.partial(
    jax.jit,
    static_argnames=("gauss_radius", "hyst_iters"),
)
def process_depth(
    depth: jax.Array,
    bf: jax.Array,
    dont_care: float = 0.0,
    gauss_radius: int = 2,
    hyst_min: float = 7.0,
    hyst_max: float = 9.0,
    hyst_iters: int = 4,
) -> jax.Array:
    """Filter one depth image; returns same-shape depth with outliers = 0.

    ``bf`` is fx * baseline of the (virtual) stereo depth camera, defining
    the local quantization step dz = z^2 / bf; the reference constructs
    StereoCamera4(depthModel.K, bf) for exactly this.
    """
    z = depth.astype(jnp.float32)
    valid = z > dont_care
    z = jnp.where(valid, z, 0.0)

    big = jnp.float32(1e9)

    # ---- hysteresis support: min |z - z_nb| over the 8-ring, in units of
    # the pairwise quantization step dz = min(z, z_nb)^2 / bf (using the
    # nearer depth keeps flying pixels from inflating their own
    # tolerance quadratically) ----
    zf = jnp.where(valid, z, big)
    min_ratio = jnp.full_like(z, big)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = _shift(zf, dy, dx, big)
            zmin = jnp.minimum(jnp.abs(nb), z)
            dz_pair = zmin * zmin / jnp.maximum(bf, 1e-6)
            d = jnp.abs(nb - z) / jnp.maximum(dz_pair, 1e-9)
            min_ratio = jnp.minimum(min_ratio, d)

    strong = valid & (min_ratio <= hyst_min)
    weak = valid & (min_ratio <= hyst_max) & ~strong

    # weak pixels survive when 4-connected to a strong pixel (grow the
    # strong region through the weak band a few steps — lax.fori over a
    # fused dilation, cheap elementwise work)
    def grow(_, s):
        n = (
            _shift(s.astype(jnp.float32), 1, 0, 0.0)
            + _shift(s.astype(jnp.float32), -1, 0, 0.0)
            + _shift(s.astype(jnp.float32), 0, 1, 0.0)
            + _shift(s.astype(jnp.float32), 0, -1, 0.0)
        )
        return s | (weak & (n > 0))

    keep = jax.lax.fori_loop(0, hyst_iters, grow, strong)
    z = jnp.where(keep, z, 0.0)

    # ---- edge-aware Gaussian: masked taps, renormalized ----
    r = int(gauss_radius)
    if r > 0:
        sigma = max(r / 2.0, 1e-3)
        offs = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
        w_np = np.array(
            [np.exp(-(dy * dy + dx * dx) / (2 * sigma * sigma))
             for dy, dx in offs], dtype=np.float32
        )
        acc = jnp.zeros_like(z)
        wacc = jnp.zeros_like(z)
        for (dy, dx), w in zip(offs, w_np):
            nb = _shift(z, dy, dx, 0.0)
            zmin = jnp.minimum(jnp.where(nb > 0, nb, big), z)
            thr = hyst_min * zmin * zmin / jnp.maximum(bf, 1e-6)
            ok = (nb > 0) & (jnp.abs(nb - z) <= thr)
            wi = jnp.where(ok, w, 0.0)
            acc = acc + wi * nb
            wacc = wacc + wi
        z = jnp.where(keep & (wacc > 0), acc / jnp.maximum(wacc, 1e-9), z)

    return jnp.where(keep, z, 0.0)


class DepthProcessor:
    """Host-side wrapper with the reference's Settings shape
    (dont_care, gauss_radius, hyst_min, hyst_max, camera)."""

    def __init__(self, fx: float, bf: float, dont_care: float = 0.0,
                 gauss_radius: int = 2, hyst_min: float = 7.0,
                 hyst_max: float = 9.0):
        self.fx = float(fx)
        self.bf = float(bf)
        self.dont_care = float(dont_care)
        self.gauss_radius = int(gauss_radius)
        self.hyst_min = float(hyst_min)
        self.hyst_max = float(hyst_max)

    def process(self, depth: np.ndarray) -> np.ndarray:
        out = process_depth(
            jnp.asarray(depth), jnp.float32(self.bf),
            dont_care=self.dont_care, gauss_radius=self.gauss_radius,
            hyst_min=self.hyst_min, hyst_max=self.hyst_max,
        )
        return np.asarray(out)
