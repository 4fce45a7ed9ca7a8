"""Camera models: pinhole intrinsics, Brown-Conrady distortion, stereo.

JAX replacement for saiga's ``IntrinsicsPinholed`` / ``Distortion`` /
``StereoCamera4`` (reference: Snake/System/SnakeGlobal.h:94-103).  All ops are
batched jnp functions over normalized image coordinates; undistortion is the
same Gauss-Newton inverse the reference applies per keypoint
(reference: Snake/Preprocess/Preprocess.cpp:55-77), vectorized over all
keypoints at once.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Pinhole(NamedTuple):
    """Pinhole intrinsics. Scalars (or broadcastable arrays)."""

    fx: jax.Array
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array

    @staticmethod
    def create(fx, fy, cx, cy, dtype=jnp.float32) -> "Pinhole":
        f = lambda v: jnp.asarray(v, dtype=dtype)
        return Pinhole(f(fx), f(fy), f(cx), f(cy))

    def matrix(self) -> jax.Array:
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack(
            [
                jnp.stack([self.fx, z, self.cx], axis=-1),
                jnp.stack([z, self.fy, self.cy], axis=-1),
                jnp.stack([z, z, o], axis=-1),
            ],
            axis=-2,
        )

    def project_normalized(self, xn: jax.Array) -> jax.Array:
        """Normalized coords (..., 2) -> pixels (..., 2)."""
        return jnp.stack(
            [xn[..., 0] * self.fx + self.cx, xn[..., 1] * self.fy + self.cy],
            axis=-1,
        )

    def unproject_pixels(self, uv: jax.Array) -> jax.Array:
        """Pixels (..., 2) -> normalized coords (..., 2)."""
        return jnp.stack(
            [(uv[..., 0] - self.cx) / self.fx, (uv[..., 1] - self.cy) / self.fy],
            axis=-1,
        )


class Distortion(NamedTuple):
    """Brown-Conrady (radtan) distortion: k1 k2 k3 radial + p1 p2 tangential.

    EuRoC/TUM calibrations use (k1, k2, p1, p2[, k3]); extra coefficients
    default to zero.
    """

    k1: jax.Array
    k2: jax.Array
    k3: jax.Array
    p1: jax.Array
    p2: jax.Array

    @staticmethod
    def create(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0, dtype=jnp.float32) -> "Distortion":
        f = lambda v: jnp.asarray(v, dtype=dtype)
        return Distortion(f(k1), f(k2), f(k3), f(p1), f(p2))

    def is_zero(self) -> bool:
        import numpy as np

        return all(
            float(np.abs(np.asarray(v)).max(initial=0.0)) == 0.0 for v in self
        )


def distort(xn: jax.Array, d: Distortion) -> jax.Array:
    """Apply distortion to normalized coords (..., 2)."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (d.k1 + r2 * (d.k2 + r2 * d.k3))
    xy2 = 2.0 * x * y
    xd = x * radial + d.p1 * xy2 + d.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + d.p2 * xy2 + d.p1 * (r2 + 2.0 * y * y)
    return jnp.stack([xd, yd], axis=-1)


def undistort(xd: jax.Array, d: Distortion, iters: int = 8) -> jax.Array:
    """Invert `distort` with Gauss-Newton, vectorized over all points.

    Mirrors saiga's ``undistortPointGN`` semantics (fixed iteration count,
    initialized at the distorted point).
    """

    def gn_step(_, xn):
        # residual r(xn) = distort(xn) - xd ; Jacobian via jax.jacfwd would be
        # per-point 2x2 — write it analytically for speed.
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (d.k1 + r2 * (d.k2 + r2 * d.k3))
        dradial_dr2 = d.k1 + r2 * (2.0 * d.k2 + 3.0 * d.k3 * r2)
        # d(r2)/dx = 2x, d(r2)/dy = 2y
        fx = x * radial + d.p1 * 2.0 * x * y + d.p2 * (r2 + 2.0 * x * x)
        fy = y * radial + d.p2 * 2.0 * x * y + d.p1 * (r2 + 2.0 * y * y)
        J00 = radial + x * dradial_dr2 * 2.0 * x + 2.0 * d.p1 * y + 6.0 * d.p2 * x
        J01 = x * dradial_dr2 * 2.0 * y + 2.0 * d.p1 * x + 2.0 * d.p2 * y
        J10 = y * dradial_dr2 * 2.0 * x + 2.0 * d.p2 * y + 2.0 * d.p1 * x
        J11 = radial + y * dradial_dr2 * 2.0 * y + 2.0 * d.p2 * x + 6.0 * d.p1 * y
        rx = fx - xd[..., 0]
        ry = fy - xd[..., 1]
        det = J00 * J11 - J01 * J10
        det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
        dx = (J11 * rx - J01 * ry) / det
        dy = (-J10 * rx + J00 * ry) / det
        return jnp.stack([x - dx, y - dy], axis=-1)

    return jax.lax.fori_loop(0, iters, gn_step, xd)


class StereoCamera(NamedTuple):
    """Stereo rig: rectified pinhole + baseline.

    ``bf`` = baseline * fx (the reference's StereoCamera4 convention); the
    virtual right x-coordinate of a point at depth Z is ``u - bf / Z``.
    """

    cam: Pinhole
    bf: jax.Array

    @property
    def baseline(self) -> jax.Array:
        return self.bf / self.cam.fx


# ---------------------------------------------------------------------------
# projection of 3D camera-space points
# ---------------------------------------------------------------------------

def project(cam: Pinhole, pc: jax.Array, eps: float = 1e-6):
    """Camera-space points (..., 3) -> (uv (..., 2), z (...,)).

    z <= eps points produce garbage uv; callers mask with z > 0.
    """
    z = pc[..., 2]
    zs = jnp.where(jnp.abs(z) < eps, eps, z)
    u = pc[..., 0] / zs * cam.fx + cam.cx
    v = pc[..., 1] / zs * cam.fy + cam.cy
    return jnp.stack([u, v], axis=-1), z


def project_stereo(scam: StereoCamera, pc: jax.Array, eps: float = 1e-6):
    """Camera-space points (..., 3) -> (uvr (..., 3) = (u, v, u_right), z)."""
    uv, z = project(scam.cam, pc, eps)
    zs = jnp.where(jnp.abs(z) < eps, eps, z)
    ur = uv[..., 0] - scam.bf / zs
    return jnp.concatenate([uv, ur[..., None]], axis=-1), z


def unproject(cam: Pinhole, uv: jax.Array, z: jax.Array) -> jax.Array:
    """Pixels (..., 2) + depth (...) -> camera-space (..., 3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * z
    y = (uv[..., 1] - cam.cy) / cam.fy * z
    return jnp.stack([x, y, z], axis=-1)
