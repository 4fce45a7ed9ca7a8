"""Fused pose-GN kernel (Pallas, Triton route): a whole robust pose refine
in ONE launch.

The windowed tracking scan (models/window_step.py) runs a robust
Gauss-Newton pose refine twice per frame inside a sequential ``lax.scan``.
XLA expands each refine into many small fusions (Jacobian sweeps, 6x6
solve, SE(3) exp, outlier classification), so the scan pays a kernel
launch per fusion per frame.  This kernel runs the ENTIRE refine —
``outer_iters`` rounds of (``inner_iters`` damped GN steps -> chi2
outlier re-classification) — as one program (one CTA):

  * the eight per-feature fields arrive as ONE packed (8, N) input and
    are loaded once; N is padded to a power of two (Triton's block rule)
    with mask = 0 rows, which carry zero weight;
  * the 6x6 normal equations and gradient accumulate as 27 block
    reductions (structurally zero Jacobian entries are skipped);
  * the 6x6 solve, SE(3) exponential and pose composition run as scalar
    arithmetic (a closed-form 3x3-block Schur elimination);
  * outputs are the refined pose row (one 16-wide store) and the inlier
    mask.

Semantics mirror ops/pose_solver.robust_pose_refine (saiga's
RobustPoseOptimization, reference: Snake/Tracking/PoseRefinement.h:9-10):
left-multiplicative update, Huber weights at the mono/stereo pixel
thresholds (SnakeGlobal.h:145-146), chi2 classification between rounds.
The motion-prior variant stays on the XLA path (used per-frame by the
tracker, not in the scan).  The kernel has no matrix products, so TF32
never enters; sums are taken in another order than XLA's, which is the
whole of the difference between the two.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from snakeslam_tpu.core.camera import Pinhole

# pose row layout of the scalar input: [0:16] row-major 4x4 pose,
# [16:24] fx fy cx cy bf chi2_mono chi2_stereo damping, [24:32] unused
_TC_SIZE = 32


# ---------------------------------------------------------------------------
# scalar 3x3 helpers (tuples of traced scalars -> pure scalar arithmetic,
# mirrors ops/linalg.inv3x3 exactly)
# ---------------------------------------------------------------------------

def _inv3(m):
    (a, b, c), (d, e, f), (g, h, i) = m
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    return ((A11 / det, A12 / det, A13 / det),
            (A21 / det, A22 / det, A23 / det),
            (A31 / det, A32 / det, A33 / det))


def _m3v(m, v):
    return tuple(m[r][0] * v[0] + m[r][1] * v[1] + m[r][2] * v[2]
                 for r in range(3))


def _m3m(a, b):
    return tuple(
        tuple(a[r][0] * b[0][c] + a[r][1] * b[1][c] + a[r][2] * b[2][c]
              for c in range(3))
        for r in range(3))


def _m3t(m):
    return tuple(tuple(m[c][r] for c in range(3)) for r in range(3))


def _solve6_scalar(H, b):
    """H: 6x6 nested scalar tuple (PSD, damped); b: 6 scalars."""
    A = tuple(tuple(H[r][c] for c in range(3)) for r in range(3))
    B = tuple(tuple(H[r][c + 3] for c in range(3)) for r in range(3))
    D = tuple(tuple(H[r + 3][c + 3] for c in range(3)) for r in range(3))
    b1 = (b[0], b[1], b[2])
    b2 = (b[3], b[4], b[5])
    Ai = _inv3(A)
    BtAi = _m3m(_m3t(B), Ai)
    S = tuple(tuple(D[r][c]
                    - (BtAi[r][0] * B[0][c] + BtAi[r][1] * B[1][c]
                       + BtAi[r][2] * B[2][c])
              for c in range(3)) for r in range(3))
    rhs2 = tuple(b2[r] - (BtAi[r][0] * b1[0] + BtAi[r][1] * b1[1]
                          + BtAi[r][2] * b1[2]) for r in range(3))
    x2 = _m3v(_inv3(S), rhs2)
    rhs1 = tuple(b1[r] - (B[r][0] * x2[0] + B[r][1] * x2[1]
                          + B[r][2] * x2[2]) for r in range(3))
    x1 = _m3v(Ai, rhs1)
    return x1 + x2


def _se3_exp_scalar(v, w):
    """Sophus-convention exp: (upsilon, omega) -> (R 3x3, t 3) scalars."""
    th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    th = jnp.sqrt(th2 + 1e-30)
    small = th < 1e-4
    a = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(th) / th)
    bb = jnp.where(small, 0.5 - th2 / 24.0, (1.0 - jnp.cos(th)) / (th2 + 1e-30))
    cc = jnp.where(small, 1.0 / 6.0 - th2 / 120.0,
                   (th - jnp.sin(th)) / (th2 * th + 1e-30))
    zero = 0.0 * th
    W = ((zero, -w[2], w[1]), (w[2], zero, -w[0]), (-w[1], w[0], zero))
    W2 = _m3m(W, W)
    eye = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
    R = tuple(tuple(eye[r][c] + a * W[r][c] + bb * W2[r][c]
              for c in range(3)) for r in range(3))
    V = tuple(tuple(eye[r][c] + bb * W[r][c] + cc * W2[r][c]
              for c in range(3)) for r in range(3))
    return R, _m3v(V, v)


def _gram_schmidt(R):
    """Project a near-rotation back to SO(3) (column-wise modified GS)."""
    c0 = (R[0][0], R[1][0], R[2][0])
    n0 = jax.lax.rsqrt(c0[0] ** 2 + c0[1] ** 2 + c0[2] ** 2 + 1e-30)
    c0 = (c0[0] * n0, c0[1] * n0, c0[2] * n0)
    c1 = (R[0][1], R[1][1], R[2][1])
    d = c0[0] * c1[0] + c0[1] * c1[1] + c0[2] * c1[2]
    c1 = (c1[0] - d * c0[0], c1[1] - d * c0[1], c1[2] - d * c0[2])
    n1 = jax.lax.rsqrt(c1[0] ** 2 + c1[1] ** 2 + c1[2] ** 2 + 1e-30)
    c1 = (c1[0] * n1, c1[1] * n1, c1[2] * n1)
    c2 = (c0[1] * c1[2] - c0[2] * c1[1],
          c0[2] * c1[0] - c0[0] * c1[2],
          c0[0] * c1[1] - c0[1] * c1[0])
    return ((c0[0], c1[0], c2[0]), (c0[1], c1[1], c2[1]),
            (c0[2], c1[2], c2[2]))


def _dot_rows(a, b):
    """sum_k a[k] * b[k] over Jacobian rows whose entries may be None
    (a structural zero): the product is dropped instead of computed.
    Returns None when every product is a structural zero."""
    terms = [x * y for x, y in zip(a, b) if x is not None and y is not None]
    if not terms:
        return None
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _pose_refine_kernel(tc_ref, data_ref, T_out_ref, inlier_ref,
                        *, outer_iters: int, inner_iters: int):
    fx = tc_ref[16]
    fy = tc_ref[17]
    cx = tc_ref[18]
    cy = tc_ref[19]
    bf = tc_ref[20]
    chi2_m = tc_ref[21]
    chi2_s = tc_ref[22]
    damping = tc_ref[23]

    px = data_ref[0, :]
    py = data_ref[1, :]
    pz = data_ref[2, :]
    uo = data_ref[3, :]
    vo = data_ref[4, :]
    ro = data_ref[5, :]
    wgt = data_ref[6, :]
    msk = data_ref[7, :] > 0.5

    has_stereo = ro > 0.0
    sflag = has_stereo.astype(jnp.float32)
    delta_h = jnp.where(has_stereo, jnp.sqrt(chi2_s), jnp.sqrt(chi2_m))
    th_cls = jnp.where(has_stereo, chi2_s, chi2_m)
    w2 = wgt * wgt

    Tf0 = tuple(tc_ref[k] for k in range(12))  # row-major R|t (3x4)

    def transform(Tf):
        X = Tf[0] * px + Tf[1] * py + Tf[2] * pz + Tf[3]
        Y = Tf[4] * px + Tf[5] * py + Tf[6] * pz + Tf[7]
        Z = Tf[8] * px + Tf[9] * py + Tf[10] * pz + Tf[11]
        return X, Y, Z

    def residuals(Tf):
        X, Y, Z = transform(Tf)
        z_ok = Z > 1e-4
        zs = jnp.where(z_ok, Z, 1.0)
        iz = 1.0 / zs
        u = fx * X * iz + cx
        v = fy * Y * iz + cy
        ru = u - uo
        rv = v - vo
        rr = jnp.where(has_stereo, u - bf * iz - ro, 0.0)
        chi2 = w2 * (ru * ru + rv * rv + rr * rr)
        return X, Y, Z, z_ok, iz, ru, rv, rr, chi2

    def gn_step(Tf, inlier):
        X, Y, Z, z_ok, iz, ru, rv, rr, chi2 = residuals(Tf)
        iz2 = iz * iz
        e = jnp.sqrt(chi2 + 1e-12)
        huber = jnp.minimum(1.0, delta_h / e)
        wt = jnp.where(msk & z_ok & inlier, w2 * huber, 0.0)
        # Jacobian rows (J = Jp @ [I | -hat(pc)], PoseRefinement.h:52-53);
        # NOTE raw Z (not the clamped zs) in the hat-block terms, matching
        # ops/pose_solver._residuals_jacobians.  Row k of the table below is
        # (du, dv, dur) / d(delta_k); None marks a structural zero.
        fxiz = fx * iz
        fyiz = fy * iz
        s_fxiz = sflag * fxiz
        cols = (
            (fxiz, None, s_fxiz),
            (None, fyiz, None),
            (-fx * X * iz2, -fy * Y * iz2, sflag * ((bf - fx * X) * iz2)),
            (-fx * X * Y * iz2, -fy * Z * iz - fy * Y * Y * iz2,
             sflag * ((bf - fx * X) * Y * iz2)),
            (fx * Z * iz + fx * X * X * iz2, fy * X * Y * iz2,
             sflag * (fx * Z * iz + (fx * X - bf) * X * iz2)),
            (-fx * Y * iz, fy * X * iz, -sflag * fx * Y * iz),
        )
        res = (ru, rv, rr)
        H = [[None] * 6 for _ in range(6)]
        for i in range(6):
            for j in range(i, 6):
                d_ij = _dot_rows(cols[i], cols[j])
                H[i][j] = 0.0 if d_ij is None else jnp.sum(wt * d_ij)
                H[j][i] = H[i][j]
        for i in range(6):
            H[i][i] = H[i][i] + damping
        b = tuple(jnp.sum(wt * _dot_rows(cols[i], res)) for i in range(6))
        d = _solve6_scalar(tuple(tuple(r) for r in H), b)
        Rd, td = _se3_exp_scalar((-d[0], -d[1], -d[2]),
                                 (-d[3], -d[4], -d[5]))
        RT = ((Tf[0], Tf[1], Tf[2]), (Tf[4], Tf[5], Tf[6]),
              (Tf[8], Tf[9], Tf[10]))
        tT = (Tf[3], Tf[7], Tf[11])
        Rn = _m3m(Rd, RT)
        tn = _m3v(Rd, tT)
        tn = (tn[0] + td[0], tn[1] + td[1], tn[2] + td[2])
        return (Rn[0][0], Rn[0][1], Rn[0][2], tn[0],
                Rn[1][0], Rn[1][1], Rn[1][2], tn[1],
                Rn[2][0], Rn[2][1], Rn[2][2], tn[2])

    Tf = Tf0
    inlier = msk
    for _ in range(outer_iters):
        for _ in range(inner_iters):
            Tf = gn_step(Tf, inlier)
        _, _, _, z_ok, _, _, _, _, chi2 = residuals(Tf)
        inlier = msk & z_ok & (chi2 <= th_cls)

    R = _gram_schmidt(((Tf[0], Tf[1], Tf[2]), (Tf[4], Tf[5], Tf[6]),
                       (Tf[8], Tf[9], Tf[10])))
    out = (R[0][0], R[0][1], R[0][2], Tf[3],
           R[1][0], R[1][1], R[1][2], Tf[7],
           R[2][0], R[2][1], R[2][2], Tf[11])
    # one 16-wide store: scatter the 12 scalars into a vector by iota
    # select; the last row is the constant (0, 0, 0, 1)
    lane = jax.lax.broadcasted_iota(jnp.int32, (16,), 0)
    row = jnp.where(lane == 15, 1.0, 0.0)
    for k, val in enumerate(out):
        row = jnp.where(lane == k, val, row)
    T_out_ref[...] = row
    inlier_ref[...] = inlier.astype(jnp.float32)


def padded_size(n: int) -> int:
    """Feature slots as the kernel sees them: the next power of two."""
    return 1 << max(n - 1, 1).bit_length()


@functools.partial(jax.jit,
                   static_argnames=("outer_iters", "inner_iters",
                                    "num_warps", "interpret"))
def pose_refine_fused(T_init, points, uv, right, weight, mask,
                      cam: Pinhole, bf,
                      chi2_mono: float = 2.1 ** 2,
                      chi2_stereo: float = 2.3 ** 2,
                      outer_iters: int = 2, inner_iters: int = 2,
                      damping: float = 1e-5,
                      num_warps: int = 8,
                      interpret: bool = False):
    """One-launch robust pose refine.  Returns (T, inlier_mask, n_inliers).

    ``points`` (N, 3), ``uv`` (N, 2), ``right``/``weight`` (N,), ``mask``
    (N,) bool, any N; the kernel runs on N padded to a power of two.
    ``interpret`` runs the Pallas interpreter (CPU tests); the default
    compiles for the GPU through Triton.
    """
    N = points.shape[0]
    Np = padded_size(N)
    f32 = jnp.float32
    data = jnp.stack([
        points[:, 0], points[:, 1], points[:, 2],
        uv[:, 0], uv[:, 1], right, weight, mask,
    ]).astype(f32)
    data = jnp.pad(data, ((0, 0), (0, Np - N)))
    tc = jnp.concatenate([
        T_init.reshape(-1).astype(f32),
        jnp.stack([cam.fx, cam.fy, cam.cx, cam.cy, bf,
                   f32(chi2_mono), f32(chi2_stereo),
                   f32(damping)]).astype(f32),
        jnp.zeros((_TC_SIZE - 24,), f32),
    ])
    T_row, inl = pl.pallas_call(
        functools.partial(_pose_refine_kernel, outer_iters=outer_iters,
                          inner_iters=inner_iters),
        out_shape=(jax.ShapeDtypeStruct((16,), f32),
                   jax.ShapeDtypeStruct((Np,), f32)),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        interpret=interpret,
        name="pose_refine_fused",
    )(tc, data)
    inlier = inl[:N] > 0.5
    return T_row.reshape(4, 4), inlier, jnp.sum(inlier)
