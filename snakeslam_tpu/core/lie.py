"""SO3 / SE3 / Sim3 Lie-group operations, batched and jit-friendly.

JAX replacement for the Sophus types used throughout the reference
(``SE3, DSim3, Vec3`` — reference: Snake/System/SnakeGlobal.h:33-43).  Poses
are stored as homogeneous ``(..., 4, 4)`` float matrices so that composition
is a plain matmul and everything vmaps.  Sim3 is represented
as a 4x4 with scaled rotation ``s*R`` in the upper-left block.

All functions accept arbitrary leading batch dimensions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------

def safe_norm(v: jax.Array) -> jax.Array:
    """L2 norm along the last axis with a well-defined (zero) derivative at
    v == 0 — jnp.linalg.norm produces NaN tangents there under jacfwd/grad."""
    n2 = jnp.sum(v * v, axis=-1)
    n = jnp.sqrt(jnp.where(n2 == 0.0, 1.0, n2))
    return jnp.where(n2 == 0.0, 0.0, n)


def hat(w: jax.Array) -> jax.Array:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jax.Array) -> jax.Array:
    """(..., 3, 3) skew -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


# Taylor cutoffs are sized for float32: the direct formulas suffer
# catastrophic cancellation (1-cos, x-sin) well above machine epsilon, so the
# switch points are large and the series carry enough terms to stay exact
# there (rel. error < 1e-7 at the boundary in both branches).

def _sinc(x: jax.Array) -> jax.Array:
    """sin(x)/x with Taylor fallback near 0."""
    x2 = x * x
    small = jnp.abs(x) < 0.05
    xs = jnp.where(small, 1.0, x)  # avoid 0/0 in the false branch
    taylor = 1.0 - x2 / 6.0 * (1.0 - x2 / 20.0)
    return jnp.where(small, taylor, jnp.sin(xs) / xs)


def _one_minus_cos_over_x2(x: jax.Array) -> jax.Array:
    """(1-cos(x))/x^2 with Taylor fallback (f32-safe cutoff)."""
    x2 = x * x
    small = jnp.abs(x) < 0.1
    xs = jnp.where(small, 1.0, x)
    taylor = 0.5 - x2 / 24.0 * (1.0 - x2 / 30.0)
    return jnp.where(small, taylor, (1.0 - jnp.cos(xs)) / (xs * xs))


def _x_minus_sin_over_x3(x: jax.Array) -> jax.Array:
    """(x-sin(x))/x^3 with Taylor fallback (f32-safe cutoff)."""
    x2 = x * x
    small = jnp.abs(x) < 0.2
    xs = jnp.where(small, 1.0, x)
    taylor = (1.0 / 6.0) * (1.0 - x2 / 20.0 * (1.0 - x2 / 42.0))
    return jnp.where(small, taylor, (xs - jnp.sin(xs)) / (xs**3))


# ---------------------------------------------------------------------------
# SO3
# ---------------------------------------------------------------------------

def so3_exp(w: jax.Array) -> jax.Array:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues)."""
    theta = safe_norm(w)
    W = hat(w)
    W2 = W @ W
    a = _sinc(theta)[..., None, None]
    b = _one_minus_cos_over_x2(theta)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a * W + b * W2


def so3_log(R: jax.Array) -> jax.Array:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3).

    Robust up to (but not exactly at) theta == pi; SLAM inter-frame rotations
    never approach pi so the simple branch suffices on the hot path.  A
    quaternion fallback handles angles near pi.
    """
    q = rotmat_to_quat(R)
    return quat_to_axis_angle(q)


def rotmat_to_quat(R: jax.Array) -> jax.Array:
    """(..., 3, 3) -> unit quaternion (..., 4) as (w, x, y, z), w >= 0.

    Shepperd's branchless method: compute all four candidate constructions
    and select the numerically best with where().
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidates, each scaled by 4*q_i^2 (always >= 0 for the max entry)
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def build(case):
        if case == 0:
            s = jnp.sqrt(jnp.maximum(qw2, _EPS)) * 2.0  # s = 4w
            return jnp.stack(
                [0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s],
                axis=-1,
            )
        if case == 1:
            s = jnp.sqrt(jnp.maximum(qx2, _EPS)) * 2.0
            return jnp.stack(
                [(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s],
                axis=-1,
            )
        if case == 2:
            s = jnp.sqrt(jnp.maximum(qy2, _EPS)) * 2.0
            return jnp.stack(
                [(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s],
                axis=-1,
            )
        s = jnp.sqrt(jnp.maximum(qz2, _EPS)) * 2.0
        return jnp.stack(
            [(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s],
            axis=-1,
        )

    cands = jnp.stack([build(0), build(1), build(2), build(3)], axis=-2)
    scores = jnp.stack([qw2, qx2, qy2, qz2], axis=-1)
    idx = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(cands, idx[..., None, None], axis=-2)[..., 0, :]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    # canonicalize sign: w >= 0
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_rotmat(q: jax.Array) -> jax.Array:
    """Unit quaternion (..., 4) (w, x, y, z) -> (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def quat_to_axis_angle(q: jax.Array) -> jax.Array:
    """Unit quaternion (w>=0) -> axis-angle (..., 3)."""
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vn = safe_norm(v)
    theta = 2.0 * jnp.arctan2(vn, w)
    # theta / sin(theta/2) = theta / vn  (vn = sin(theta/2) for unit quats)
    small = vn < 1e-7
    scale = jnp.where(small, 2.0 + theta * theta / 12.0, theta / jnp.where(small, 1.0, vn))
    return v * scale[..., None]


# ---------------------------------------------------------------------------
# SE3  — (..., 4, 4) homogeneous matrices
# ---------------------------------------------------------------------------

def se3(R: jax.Array, t: jax.Array) -> jax.Array:
    """Assemble (..., 4, 4) from rotation (..., 3, 3) and translation (..., 3)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def se3_identity(batch=(), dtype=jnp.float32) -> jax.Array:
    return jnp.broadcast_to(jnp.eye(4, dtype=dtype), tuple(batch) + (4, 4))


def rotation(T: jax.Array) -> jax.Array:
    return T[..., :3, :3]


def translation(T: jax.Array) -> jax.Array:
    return T[..., :3, 3]


def se3_inverse(T: jax.Array) -> jax.Array:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return se3(Rt, -(Rt @ t[..., None])[..., 0])


def se3_exp(xi: jax.Array) -> jax.Array:
    """Tangent (..., 6) = (upsilon[3], omega[3]) -> (..., 4, 4).

    Convention: translation part first (v), rotation part second (w) —
    matching Sophus' SE3::exp ordering used by the reference solvers.
    """
    v = xi[..., :3]
    w = xi[..., 3:]
    theta = safe_norm(w)
    W = hat(w)
    W2 = W @ W
    R = so3_exp(w)
    b = _one_minus_cos_over_x2(theta)[..., None, None]
    c = _x_minus_sin_over_x3(theta)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    V = eye + b * W + c * W2
    t = (V @ v[..., None])[..., 0]
    return se3(R, t)


def se3_log(T: jax.Array) -> jax.Array:
    """(..., 4, 4) -> tangent (..., 6) = (v, w)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta = safe_norm(w)
    W = hat(w)
    W2 = W @ W
    # V^{-1} = I - 1/2 W + (1/theta^2)(1 - A/(2B)) W^2,  A=sinc, B=(1-cos)/th^2
    A = _sinc(theta)
    B = _one_minus_cos_over_x2(theta)
    small = theta < 0.1  # f32-safe: 1 - A/(2B) cancels near 0
    th2 = jnp.where(small, 1.0, theta * theta)
    t2 = theta * theta
    taylor = (1.0 / 12.0) * (1.0 + t2 / 60.0)  # 1/12 + th^2/720 + O(th^4)
    coef = jnp.where(small, taylor, (1.0 - A / (2.0 * B)) / th2)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    Vinv = eye - 0.5 * W + coef[..., None, None] * W2
    v = (Vinv @ t[..., None])[..., 0]
    return jnp.concatenate([v, w], axis=-1)


def orthonormalize(T: jax.Array) -> jax.Array:
    """Project the rotation block back onto SO(3) (quaternion roundtrip).

    f32 pose compositions accumulate a non-orthonormal defect that GROWS
    GEOMETRICALLY through se3_inverse (which assumes R^T == R^-1) — a few
    chained predict/update/compose steps are enough to bias solvers by
    millimeters.  Solvers call this after every pose update."""
    R = quat_to_rotmat(rotmat_to_quat(T[..., :3, :3]))
    return se3(R, T[..., :3, 3])


def transform_points(T: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


def transform_point(T: jax.Array, p: jax.Array) -> jax.Array:
    """Apply (..., 4, 4) to a single point (..., 3)."""
    return (T[..., :3, :3] @ p[..., None])[..., 0] + T[..., :3, 3]


# ---------------------------------------------------------------------------
# Sim3 — (..., 4, 4) with sR in the upper-left block
# ---------------------------------------------------------------------------

def sim3(s: jax.Array, R: jax.Array, t: jax.Array) -> jax.Array:
    s = jnp.asarray(s)
    return se3(R * s[..., None, None], t)


def sim3_scale(S: jax.Array) -> jax.Array:
    """Recover scale from the sR block (det(sR) = s^3)."""
    sR = S[..., :3, :3]
    return jnp.linalg.norm(sR[..., 0, :], axis=-1)


def sim3_rotation(S: jax.Array) -> jax.Array:
    s = sim3_scale(S)
    return S[..., :3, :3] / s[..., None, None]


def sim3_inverse(S: jax.Array) -> jax.Array:
    s = sim3_scale(S)
    R = S[..., :3, :3] / s[..., None, None]
    t = S[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    sinv = 1.0 / s
    return sim3(sinv, Rt, -(sinv[..., None] * (Rt @ t[..., None])[..., 0]))


def _sim3_W_coeffs(sigma: jax.Array, theta: jax.Array):
    """Coefficients (a, b, c) of the Sim3 W-matrix
    Wm = a I + b hat(w) + c hat(w)^2 (Strasdat's Sim3 exponential)."""
    s = jnp.exp(sigma)
    eps = 1e-5
    sig_small = jnp.abs(sigma) < eps
    sig_safe = jnp.where(sig_small, 1.0, sigma)
    a = jnp.where(sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                  (s - 1.0) / sig_safe)

    th_small = theta < eps
    th = jnp.where(th_small, 1.0, theta)
    th2 = th * th
    denom = sigma * sigma + th2
    denom = jnp.where(denom < 1e-12, 1.0, denom)
    c_cos = s * jnp.cos(th)
    c_sin = s * jnp.sin(th)
    b_gen = (sigma * c_sin + (1.0 - c_cos) * th) / (th * denom)
    c_gen = (a - ((c_cos - 1.0) * sigma + c_sin * th) / denom) / th2

    b_th0 = jnp.where(
        sig_small, 0.5 + sigma / 3.0,
        (sigma * s - s + 1.0) / (sig_safe * sig_safe),
    )
    c_th0 = jnp.where(
        sig_small, 1.0 / 6.0 + sigma / 8.0,
        ((0.5 * sigma * sigma - sigma + 1.0) * s - 1.0
         - 0.5 * sigma * sigma) / (sig_safe**3),
    )
    b = jnp.where(th_small, b_th0, b_gen)
    c = jnp.where(th_small, c_th0, c_gen)
    return a, b, c


def _sim3_W(w: jax.Array, sigma: jax.Array) -> jax.Array:
    theta = safe_norm(w)
    a, b, c = _sim3_W_coeffs(sigma, theta)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return (a[..., None, None] * eye + b[..., None, None] * W
            + c[..., None, None] * W2)


def sim3_exp(xi: jax.Array) -> jax.Array:
    """Sim3 tangent (..., 7) = (v[3], w[3], sigma) -> (..., 4, 4) with sR."""
    v = xi[..., :3]
    w = xi[..., 3:6]
    sigma = xi[..., 6]
    Wm = _sim3_W(w, sigma)
    t = (Wm @ v[..., None])[..., 0]
    return sim3(jnp.exp(sigma), so3_exp(w), t)


def sim3_log(S: jax.Array) -> jax.Array:
    """(..., 4, 4) Sim3 -> tangent (..., 7) = (v, w, sigma)."""
    s = sim3_scale(S)
    R = sim3_rotation(S)
    t = S[..., :3, 3]
    sigma = jnp.log(s)
    w = so3_log(R)
    Wm = _sim3_W(w, sigma)
    v = jnp.linalg.solve(Wm, t[..., None])[..., 0]
    return jnp.concatenate([v, w, sigma[..., None]], axis=-1)


def se3_to_sim3(T: jax.Array) -> jax.Array:
    return T


def sim3_to_se3(S: jax.Array) -> jax.Array:
    """Drop the scale (keep rotation + translation)."""
    return se3(sim3_rotation(S), S[..., :3, 3])


# ---------------------------------------------------------------------------
# storage conversions (host map arrays keep poses as (..., 7) = qwxyz + t)
# ---------------------------------------------------------------------------

def se3_to_qt(T: jax.Array) -> jax.Array:
    """(..., 4, 4) -> (..., 7) = (qw, qx, qy, qz, tx, ty, tz)."""
    q = rotmat_to_quat(T[..., :3, :3])
    return jnp.concatenate([q, T[..., :3, 3]], axis=-1)


def qt_to_se3(qt: jax.Array) -> jax.Array:
    return se3(quat_to_rotmat(qt[..., :4]), qt[..., 4:])
