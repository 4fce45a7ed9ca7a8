"""IMU kernels: preintegration, linear init solvers, decoupled chain solver.

JAX replacement for saiga's IMU stack used by the reference
(reference call sites: Snake/Map/Keyframe.cpp:390-446 preintegration,
Snake/IMU/ImuStateSolver.cpp:240 SolveGlobalGyroBias, :406-413
SolveScaleGravityLinear / SolveScaleGravityBiasLinear, Snake/IMU/
FullSolver.cpp:255-267 DecoupledImuSolver).  Everything is a fixed-shape
jitted program: preintegration is a masked ``lax.scan`` over padded sample
windows (vmapped over keyframes), the linear initializers are batched
least-squares over keyframe pairs/triplets, and the decoupled solver is a
Gauss-Newton over the keyframe chain with jacfwd-assembled dense normal
equations (the state is small: 3 velocities per KF + 9 shared parameters).

Conventions:
  * Body/world rotations R_wb (body -> world); p, v in world.
  * Preintegration deltas follow Forster et al. (TRO'16) with first-order
    bias Jacobians.
  * Gravity vector g points "down" in world coords (|g| = 9.81).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from snakeslam_tpu.core import lie
from snakeslam_tpu.ops.linalg import solve3x3, solve_psd

GRAVITY = 9.81


class Preint(NamedTuple):
    """Preintegrated IMU delta between two frames/keyframes."""

    dR: jax.Array      # (3, 3)
    dv: jax.Array      # (3,)
    dp: jax.Array      # (3,)
    dt: jax.Array      # ()
    # first-order bias Jacobians
    J_R_bg: jax.Array  # (3, 3)
    J_v_bg: jax.Array  # (3, 3)
    J_v_ba: jax.Array  # (3, 3)
    J_p_bg: jax.Array  # (3, 3)
    J_p_ba: jax.Array  # (3, 3)


def _right_jacobian(w):
    """SO3 right Jacobian Jr(w)."""
    theta = lie.safe_norm(w)
    W = lie.hat(w)
    W2 = W @ W
    b = lie._one_minus_cos_over_x2(theta)[..., None, None]
    c = lie._x_minus_sin_over_x3(theta)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - b * W + c * W2


@functools.partial(jax.jit, static_argnames=())
def preintegrate(omega: jax.Array, acc: jax.Array, dt: jax.Array,
                 mask: jax.Array, bg: jax.Array, ba: jax.Array) -> Preint:
    """Integrate a padded window of IMU samples.

    Args:
      omega, acc: (S, 3) gyro (rad/s) / accelerometer (m/s^2) samples.
      dt: (S,) per-sample integration interval (s); mask: (S,) valid.
      bg, ba: (3,) gyro / accelerometer bias estimates.
    """
    dtype = omega.dtype
    I3 = jnp.eye(3, dtype=dtype)

    def step(carry, inp):
        dR, dv, dp, T, JRbg, Jvbg, Jvba, Jpbg, Jpba = carry
        w, a, h, m = inp
        h = jnp.where(m, h, 0.0)
        wb = w - bg
        ab = a - ba
        dR_inc = lie.so3_exp(wb * h)
        Jr = _right_jacobian(wb * h)
        hat_ab = lie.hat(ab)
        # position/velocity first (use dR at the interval start)
        dp = dp + dv * h + 0.5 * (dR @ ab) * h * h
        Jpbg = Jpbg + Jvbg * h - 0.5 * dR @ hat_ab @ JRbg * h * h
        Jpba = Jpba + Jvba * h - 0.5 * dR * h * h
        dv = dv + (dR @ ab) * h
        Jvbg = Jvbg - dR @ hat_ab @ JRbg * h
        Jvba = Jvba - dR * h
        # rotation last
        JRbg = dR_inc.T @ JRbg - Jr * h
        dR = dR @ dR_inc
        T = T + h
        return (dR, dv, dp, T, JRbg, Jvbg, Jvba, Jpbg, Jpba), None

    Z3 = jnp.zeros((3, 3), dtype=dtype)
    z = jnp.zeros(3, dtype=dtype)
    init = (I3, z, z, jnp.zeros((), dtype=dtype), Z3, Z3, Z3, Z3, Z3)
    (dR, dv, dp, T, JRbg, Jvbg, Jvba, Jpbg, Jpba), _ = jax.lax.scan(
        step, init, (omega, acc, dt, mask)
    )
    return Preint(dR, dv, dp, T, JRbg, Jvbg, Jvba, Jpbg, Jpba)


# batch over keyframe windows: (K, S, 3) samples -> Preint with leading K
preintegrate_batch = jax.jit(
    jax.vmap(preintegrate, in_axes=(0, 0, 0, 0, None, None))
)


def preint_with_bias_correction(p: Preint, dbg, dba):
    """First-order-corrected deltas for a bias change (dbg, dba)."""
    dR = p.dR @ lie.so3_exp(p.J_R_bg @ dbg)
    dv = p.dv + p.J_v_bg @ dbg + p.J_v_ba @ dba
    dp = p.dp + p.J_p_bg @ dbg + p.J_p_ba @ dba
    return dR, dv, dp


def predict(p: Preint, R_i, v_i, p_i, g):
    """Forward state prediction across the preintegrated interval."""
    dt = p.dt
    R_j = R_i @ p.dR
    v_j = v_i + g * dt + R_i @ p.dv
    p_j = p_i + v_i * dt + 0.5 * g * dt * dt + R_i @ p.dp
    return R_j, v_j, p_j


# ---------------------------------------------------------------------------
# gyro bias: GN over keyframe rotation pairs (SolveGlobalGyroBias parity)
# ---------------------------------------------------------------------------

@jax.jit
def solve_gyro_bias(
    R_i: jax.Array,       # (K, 3, 3) body->world at interval starts
    R_j: jax.Array,       # (K, 3, 3) at interval ends
    dR: jax.Array,        # (K, 3, 3) preintegrated (at current bias)
    J_R_bg: jax.Array,    # (K, 3, 3)
    valid: jax.Array,     # (K,)
):
    """One GN step for the shared gyro bias increment.

    Residual per pair: r = Log( (dR Exp(J dbg))^T R_i^T R_j ).
    Returns (dbg (3,), rms residual before the step).
    """
    rel = jnp.swapaxes(dR, -1, -2) @ jnp.swapaxes(R_i, -1, -2) @ R_j
    r = lie.so3_log(rel)                       # (K, 3)
    # r(dbg) = Log(Exp(-J_R_bg dbg) Exp(r)): left perturbation, so
    # dr/d(dbg) = -Jl_inv(r) J_R_bg with Jl_inv(r) = Jr_inv(-r)
    J = -_right_jacobian_inv(-r) @ J_R_bg      # (K, 3, 3)
    w = valid.astype(r.dtype)
    H = jnp.einsum("kij,k,kil->jl", J, w, J)
    b = jnp.einsum("kij,k,ki->j", J, w, r)
    dbg = solve3x3(H + 1e-9 * jnp.eye(3, dtype=r.dtype), -b)
    rms = jnp.sqrt(
        jnp.sum(w * jnp.sum(r * r, axis=-1)) / jnp.maximum(jnp.sum(w), 1.0)
    )
    return dbg, rms


def _right_jacobian_inv(w):
    theta = lie.safe_norm(w)
    W = lie.hat(w)
    W2 = W @ W
    A = lie._sinc(theta)
    B = lie._one_minus_cos_over_x2(theta)
    small = theta < 0.1
    th2 = jnp.where(small, 1.0, theta * theta)
    coef = jnp.where(small, (1.0 / 12.0) * (1.0 + th2 / 60.0),
                     (1.0 - A / (2.0 * B)) / th2)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + 0.5 * W + coef[..., None, None] * W2


# ---------------------------------------------------------------------------
# scale / gravity / acc-bias: linear solve over keyframe triplets
# (SolveScaleGravityLinear / SolveScaleGravityBiasLinear parity)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("with_acc_bias", "with_lever"))
def solve_scale_gravity(
    R: jax.Array,         # (K, 3, 3) body->world (visual, unscaled)
    p: jax.Array,         # (K, 3) camera centers (visual, unscaled)
    dt12: jax.Array,      # (K-2,) preint dt between i,i+1
    dt23: jax.Array,      # (K-2,) between i+1,i+2
    dp12: jax.Array,      # (K-2, 3) preintegrated position deltas
    dp23: jax.Array,
    dv12: jax.Array,      # (K-2, 3)
    valid: jax.Array,     # (K-2,)
    Jp12_ba: jax.Array | None = None,   # (K-2, 3, 3) bias Jacobians
    Jp23_ba: jax.Array | None = None,
    Jv12_ba: jax.Array | None = None,
    with_acc_bias: bool = False,
    R_cam: jax.Array | None = None,     # (K, 3, 3) camera->world rotations
    t_cb: jax.Array | None = None,      # (3,) body origin in camera frame
    with_lever: bool = False,
):
    """Linear estimation of scale s, gravity g (and optionally acc bias).

    From the preintegration equations with velocities eliminated across each
    consecutive keyframe triplet (i, j, k):

      s * [(pk-pj) - (pj-pi) * dt23/dt12]
        + g * [-0.5 * dt23 * (dt12 + dt23)]  (times identity)
        (+ ba-Jacobian terms)
      = R_i dp12 * (-dt23/dt12) + R_i dv12 * dt23 + R_j dp23
        (- lever-arm term, see below)

    Camera-IMU extrinsics (the reference solves in body frame with full
    camera_to_body, Snake/IMU/ImuStateSolver.cpp:352-466 via saiga's
    SolveScaleGravityLinear):  the body position is affine in the visual
    scale, p_wb = s * p_wc + R_wc t_cb, so the rotation chain R must be
    BODY rotations (R_wb = R_wc R_cb^-1) and the known lever contribution

        [(R_wc_k - R_wc_j) - (R_wc_j - R_wc_i) * dt23/dt12] @ t_cb

    moves to the right-hand side.  Identity extrinsics reduce exactly to
    the lever-free equations.

    Returns (s, g (3,), ba (3,), residual_rms).
    """
    K2 = dt12.shape[0]
    p_i, p_j, p_k = p[:-2], p[1:-1], p[2:]
    R_i, R_j = R[:-2], R[1:-1]

    lam = (p_k - p_j) - (p_j - p_i) * (dt23 / dt12)[:, None]   # (K2, 3) * s
    beta = (-0.5 * dt23 * (dt12 + dt23))[:, None, None] * jnp.eye(
        3, dtype=p.dtype
    )                                                          # (K2, 3, 3) * g
    gamma = (
        -jnp.einsum("kij,kj->ki", R_i, dp12) * (dt23 / dt12)[:, None]
        + jnp.einsum("kij,kj->ki", R_i, dv12) * dt23[:, None]
        + jnp.einsum("kij,kj->ki", R_j, dp23)
    )
    if with_lever:
        arm_i = jnp.einsum("kij,j->ki", R_cam[:-2], t_cb)
        arm_j = jnp.einsum("kij,j->ki", R_cam[1:-1], t_cb)
        arm_k = jnp.einsum("kij,j->ki", R_cam[2:], t_cb)
        gamma = gamma - (
            (arm_k - arm_j) - (arm_j - arm_i) * (dt23 / dt12)[:, None]
        )
    if with_acc_bias:
        # d(gamma)/d(ba): the preint deltas shift by J_*_ba @ ba
        Aba = (
            -jnp.einsum("kij,kjl->kil", R_i, Jp12_ba)
            * (dt23 / dt12)[:, None, None]
            + jnp.einsum("kij,kjl->kil", R_i, Jv12_ba) * dt23[:, None, None]
            + jnp.einsum("kij,kjl->kil", R_j, Jp23_ba)
        )
        A = jnp.concatenate(
            [lam[:, :, None], beta, -Aba], axis=2
        )                                                       # (K2, 3, 7)
        nu = 7
    else:
        A = jnp.concatenate([lam[:, :, None], beta], axis=2)    # (K2, 3, 4)
        nu = 4
    w = valid.astype(p.dtype)
    Af = (A * w[:, None, None]).reshape(-1, nu)
    bf = (gamma * w[:, None]).reshape(-1)
    H = Af.T @ Af
    rhs = Af.T @ bf
    # pivoted LU, not Cholesky: H = Af^T Af mixes scale/gravity/bias
    # columns whose magnitudes differ by orders of magnitude — f32
    # Cholesky can go NaN on the resulting conditioning, and this solve
    # runs once per VI-init stage (cold path, robustness over speed)
    x = jnp.linalg.solve(H + 1e-9 * jnp.eye(nu, dtype=p.dtype), rhs)
    s = x[0]
    g = x[1:4]
    ba = x[4:7] if with_acc_bias else jnp.zeros(3, dtype=p.dtype)
    resid = Af @ x - bf
    rms = jnp.sqrt(jnp.mean(resid**2))
    return s, g, ba, rms


@jax.jit
def velocities_from_pairs(R, p, dt, dp, valid, s, g, dv=None):
    """Closed-form per-KF velocities given scale and gravity:
    v_i = (s (p_j - p_i) - 0.5 g dt^2 - R_i dp) / dt  for each pair (i, j);
    the last keyframe propagates the final pair through the velocity
    equation v_j = v_i + g dt + R_i dv.  dv is the preintegrated velocity
    (specific force) delta per edge; it contains -g dt, so omitting it
    would bias the last velocity by ~|g| dt."""
    p_i, p_j = p[:-1], p[1:]
    R_i = R[:-1]
    num = (
        s * (p_j - p_i)
        - 0.5 * g[None, :] * (dt**2)[:, None]
        - jnp.einsum("kij,kj->ki", R_i, dp)
    )
    v = num / jnp.maximum(dt, 1e-6)[:, None]
    v = jnp.where(valid[:, None], v, 0.0)
    v_last = v[-1] + g * dt[-1]
    if dv is not None:
        v_last = v_last + R_i[-1] @ dv[-1]
    return jnp.concatenate([v, v_last[None]], axis=0)


# ---------------------------------------------------------------------------
# decoupled chain solver (DecoupledImuScene parity)
# ---------------------------------------------------------------------------

class ImuChain(NamedTuple):
    """Fixed-shape decoupled VI problem over the keyframe chain (K slots)."""

    R: jax.Array        # (K, 3, 3) body->world (held constant — decoupled!)
    p: jax.Array        # (K, 3) positions (constant, unscaled)
    v: jax.Array        # (K, 3) velocity states
    dt: jax.Array       # (K-1,) preint dt per edge
    dR: jax.Array       # (K-1, 3, 3)
    dv: jax.Array       # (K-1, 3)
    dp: jax.Array       # (K-1, 3)
    J_R_bg: jax.Array   # (K-1, 3, 3)
    J_v_bg: jax.Array   # (K-1, 3, 3)
    J_v_ba: jax.Array   # (K-1, 3, 3)
    J_p_bg: jax.Array   # (K-1, 3, 3)
    J_p_ba: jax.Array   # (K-1, 3, 3)
    edge_valid: jax.Array  # (K-1,)


@functools.partial(
    jax.jit,
    static_argnames=("solve_bg", "solve_ba", "solve_velocity",
                     "solve_gravity", "solve_scale", "iterations",
                     "weight_R", "weight_P", "weight_V",
                     "prior_bias_weight"),
)
def solve_imu_chain(
    chain: ImuChain,
    bg0: jax.Array, ba0: jax.Array, g0: jax.Array, s0: jax.Array,
    weight_R: float = 1000.0,
    weight_P: float = 100.0,
    weight_V: float = 10.0,
    solve_bg: bool = True,
    solve_ba: bool = True,
    solve_velocity: bool = True,
    solve_gravity: bool = True,
    solve_scale: bool = False,
    iterations: int = 3,
    prior_bias_weight: float = 0.0,
):
    """Gauss-Newton over {velocities, bg, ba, gravity direction, log-scale}.

    Residuals per chain edge (i, j), following the decoupled formulation
    (visual poses R, p constant; weights R/P/V from Snake/IMU/
    FullSolver.cpp:207-269):
      r_R = Log((dR Exp(J dbg))^T R_i^T R_j)                    * sqrt(wR)/dt
      r_v = R_i^T (v_j - v_i - g dt) - (dv + Jvbg dbg + Jvba dba) * sqrt(wV)/dt
      r_p = R_i^T (s (p_j - p_i) - v_i dt - 0.5 g dt^2)
            - (dp + Jpbg dbg + Jpba dba)                         * sqrt(wP)/dt

    The full dense Jacobian is assembled with jacfwd — the state is tiny
    (3K + 9) and this runs only in initialization/refinement.
    Returns dict(v, bg, ba, g, s, cost).
    """
    K = chain.R.shape[0]
    dtype = chain.R.dtype

    g_norm = jnp.float32(GRAVITY).astype(dtype)

    def unpack(x):
        v = x[: 3 * K].reshape(K, 3)
        bg = bg0 + x[3 * K: 3 * K + 3]
        ba = ba0 + x[3 * K + 3: 3 * K + 6]
        # gravity via 2-dof rotation of the current direction
        theta = x[3 * K + 6: 3 * K + 8]
        g_dir = g0 / jnp.maximum(jnp.linalg.norm(g0), 1e-9)
        # two tangent directions orthogonal to g_dir
        b1 = jnp.linalg.cross(g_dir, jnp.asarray([1.0, 0.0, 0.0], dtype=dtype))
        b1 = jnp.where(jnp.linalg.norm(b1) < 1e-3,
                       jnp.linalg.cross(g_dir, jnp.asarray([0.0, 1.0, 0.0],
                                                           dtype=dtype)), b1)
        b1 = b1 / jnp.maximum(jnp.linalg.norm(b1), 1e-9)
        b2 = jnp.linalg.cross(g_dir, b1)
        g = g_norm * (lie.so3_exp(theta[0] * b1 + theta[1] * b2) @ g_dir)
        s = s0 * jnp.exp(x[3 * K + 8])
        return v, bg, ba, g, s

    sqwR, sqwP, sqwV = (jnp.sqrt(jnp.asarray(w, dtype=dtype))
                        for w in (weight_R, weight_P, weight_V))

    def residuals(x):
        v, bg, ba, g, s = unpack(x)
        dbg = bg - bg0
        dba = ba - ba0
        R_i, R_j = chain.R[:-1], chain.R[1:]
        p_i, p_j = chain.p[:-1], chain.p[1:]
        v_i, v_j = v[:-1], v[1:]
        dt = chain.dt
        inv_dt = 1.0 / jnp.maximum(dt, 1e-4)

        dR_c = chain.dR @ lie.so3_exp(
            jnp.einsum("kij,j->ki", chain.J_R_bg, dbg)
        )
        dv_c = chain.dv + jnp.einsum("kij,j->ki", chain.J_v_bg, dbg) \
            + jnp.einsum("kij,j->ki", chain.J_v_ba, dba)
        dp_c = chain.dp + jnp.einsum("kij,j->ki", chain.J_p_bg, dbg) \
            + jnp.einsum("kij,j->ki", chain.J_p_ba, dba)

        r_R = lie.so3_log(
            jnp.swapaxes(dR_c, -1, -2) @ jnp.swapaxes(R_i, -1, -2) @ R_j
        )
        r_v = jnp.einsum("kij,ki->kj", R_i,
                         (v_j - v_i - g[None] * dt[:, None])) - dv_c
        r_p = jnp.einsum(
            "kij,ki->kj", R_i,
            (s * (p_j - p_i) - v_i * dt[:, None]
             - 0.5 * g[None] * (dt**2)[:, None]),
        ) - dp_c
        w = chain.edge_valid.astype(dtype)[:, None] * inv_dt[:, None]
        r = jnp.concatenate(
            [r_R * sqwR * w, r_v * sqwV * w, r_p * sqwP * w], axis=1
        ).reshape(-1)
        if prior_bias_weight > 0:
            r = jnp.concatenate([
                r,
                jnp.sqrt(jnp.asarray(prior_bias_weight, dtype=dtype))
                * jnp.concatenate([dbg, dba]),
            ])
        return r

    n_state = 3 * K + 9
    mask = jnp.concatenate([
        jnp.full((3 * K,), 1.0 if solve_velocity else 0.0, dtype=dtype),
        jnp.full((3,), 1.0 if solve_bg else 0.0, dtype=dtype),
        jnp.full((3,), 1.0 if solve_ba else 0.0, dtype=dtype),
        jnp.full((2,), 1.0 if solve_gravity else 0.0, dtype=dtype),
        jnp.full((1,), 1.0 if solve_scale else 0.0, dtype=dtype),
    ])

    def gn_step(_, x):
        r = residuals(x)
        J = jax.jacfwd(residuals)(x)
        J = J * mask[None, :]
        H = J.T @ J + 1e-6 * jnp.eye(n_state, dtype=dtype)
        b = J.T @ r
        # pivoted LU (see solve_scale_gravity): velocity/bias/gravity
        # blocks make H too ill-conditioned for f32 Cholesky
        return x - mask * jnp.linalg.solve(H, b)

    x0 = jnp.zeros(n_state, dtype=dtype).at[: 3 * K].set(
        chain.v.reshape(-1)
    )
    # velocities enter the state absolutely (not as increments)
    x = jax.lax.fori_loop(0, iterations, gn_step, x0)
    v, bg, ba, g, s = unpack(x)
    cost = jnp.sum(residuals(x) ** 2)
    return dict(v=v, bg=bg, ba=ba, g=g, s=s, cost=cost)


# ---------------------------------------------------------------------------
# bucketed host front doors + numpy helpers
#
# The VI init state machine calls the solvers above once per keyframe with
# chain/sample arrays whose lengths GROW every call — unpadded, every length
# is a fresh XLA executable (measured: the mono-VI bench lane spent ~95% of
# its wall clock compiling, 1.2 tracked FPS).  These wrappers pad to
# power-of-two buckets with valid masks so each solver compiles once per
# bucket, and the tiny closed-form pieces run in numpy (no device at all).
# ---------------------------------------------------------------------------


def _pow2_bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def preintegrate_np(omega, acc, dt, bg, ba) -> Preint:
    """Pure-HOST preintegration (numpy f64), bit-matching the jitted scan.

    Preintegration is inherently sequential 3x3 work over <= a few hundred
    samples — each device call pays a blocking dispatch + fetch and each
    distinct sample count used to compile a fresh scan, while the VI state
    machine re-preintegrates every edge after every bias update
    (RecomputeWeights)."""
    import numpy as np

    bg = np.asarray(bg, np.float64)
    ba = np.asarray(ba, np.float64)
    I3 = np.eye(3)
    dR = I3.copy()
    dv = np.zeros(3)
    dp = np.zeros(3)
    T = 0.0
    JRbg = np.zeros((3, 3)); Jvbg = np.zeros((3, 3))
    Jvba = np.zeros((3, 3)); Jpbg = np.zeros((3, 3))
    Jpba = np.zeros((3, 3))

    def _hat(w):
        return np.array([[0.0, -w[2], w[1]],
                         [w[2], 0.0, -w[0]],
                         [-w[1], w[0], 0.0]])

    for w, a, h in zip(np.asarray(omega, np.float64),
                       np.asarray(acc, np.float64),
                       np.asarray(dt, np.float64)):
        wb = (w - bg) * h
        ab = a - ba
        th = float(np.linalg.norm(wb))
        W = _hat(wb)
        W2 = W @ W
        if th < 1e-8:
            dR_inc = I3 + W + 0.5 * W2
            Jr = I3 - 0.5 * W + W2 / 6.0
        else:
            s, c = np.sin(th), np.cos(th)
            dR_inc = I3 + (s / th) * W + ((1 - c) / th**2) * W2
            Jr = I3 - ((1 - c) / th**2) * W + ((th - s) / th**3) * W2
        hat_ab = _hat(ab)
        dp = dp + dv * h + 0.5 * (dR @ ab) * h * h
        Jpbg = Jpbg + Jvbg * h - 0.5 * dR @ hat_ab @ JRbg * h * h
        Jpba = Jpba + Jvba * h - 0.5 * dR * h * h
        dv = dv + (dR @ ab) * h
        Jvbg = Jvbg - dR @ hat_ab @ JRbg * h
        Jvba = Jvba - dR * h
        JRbg = dR_inc.T @ JRbg - Jr * h
        dR = dR @ dR_inc
        T = T + h
    return Preint(dR, dv, dp, T, JRbg, Jvbg, Jvba, Jpbg, Jpba)


def so3_log_np(R):
    """Batched numpy SO3 log map (host-side; chain-length arrays would
    recompile the jitted one per length)."""
    import numpy as np

    R = np.asarray(R, dtype=np.float64)
    tr = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(tr)
    w = np.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], axis=-1)
    s = 2.0 * np.sin(theta)
    # small angle: w/2 is already the log; near pi fall back through the
    # symmetric part (rare in these residuals — gyro errors are small)
    scale = np.where(theta[..., None] < 1e-7, 0.5,
                     theta[..., None] / np.maximum(s[..., None], 1e-12))
    return w * scale


def velocities_from_pairs_np(R, p, dt, dp, s, g, dv=None):
    """Numpy twin of velocities_from_pairs (closed form, ~20 elements —
    a device call costs more than the arithmetic)."""
    import numpy as np

    R = np.asarray(R, np.float64)
    p = np.asarray(p, np.float64)
    dt = np.asarray(dt, np.float64)
    dp = np.asarray(dp, np.float64)
    p_i, p_j = p[:-1], p[1:]
    R_i = R[:-1]
    num = (s * (p_j - p_i) - 0.5 * g[None, :] * (dt**2)[:, None]
           - np.einsum("kij,kj->ki", R_i, dp))
    v = num / np.maximum(dt, 1e-6)[:, None]
    v_last = v[-1] + g * dt[-1]
    if dv is not None:
        v_last = v_last + R_i[-1] @ np.asarray(dv, np.float64)[-1]
    return np.concatenate([v, v_last[None]], axis=0)


def so3_exp_np(w):
    """Batched numpy SO3 exp map (host-side twin of lie.so3_exp)."""
    import numpy as np

    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w, axis=-1)
    W = np.zeros(w.shape[:-1] + (3, 3))
    W[..., 0, 1] = -w[..., 2]; W[..., 0, 2] = w[..., 1]
    W[..., 1, 0] = w[..., 2];  W[..., 1, 2] = -w[..., 0]
    W[..., 2, 0] = -w[..., 1]; W[..., 2, 1] = w[..., 0]
    W2 = W @ W
    small = th < 1e-8
    ths = np.where(small, 1.0, th)
    a = np.where(small, 1.0, np.sin(ths) / ths)[..., None, None]
    b = np.where(small, 0.5, (1 - np.cos(ths)) / ths**2)[..., None, None]
    return np.eye(3) + a * W + b * W2


def solve_gyro_bias_np(R_i, R_j, dR, J_R_bg, valid):
    """Host twin of solve_gyro_bias: one GN step for the shared gyro-bias
    increment (3x3 normal equations over <=hundreds of edges — a device
    call costs a blocking dispatch + fetch per VI-init iteration)."""
    import numpy as np

    rel = np.swapaxes(dR, -1, -2) @ np.swapaxes(R_i, -1, -2) @ R_j
    r = so3_log_np(rel)                                     # (K, 3)
    # Jr_inv(-r): Jl_inv(r) = I + 0.5 W + (1/th^2 - (1+cos)/(2 th sin)) W^2
    th = np.linalg.norm(r, axis=-1)
    W = np.zeros(r.shape[:-1] + (3, 3))
    W[..., 0, 1] = -r[..., 2]; W[..., 0, 2] = r[..., 1]
    W[..., 1, 0] = r[..., 2];  W[..., 1, 2] = -r[..., 0]
    W[..., 2, 0] = -r[..., 1]; W[..., 2, 1] = r[..., 0]
    W2 = W @ W
    small = th < 1e-7
    ths = np.where(small, 1.0, th)
    c = np.where(
        small, 1.0 / 12.0,
        1.0 / ths**2 - (1.0 + np.cos(ths)) / (2.0 * ths * np.sin(ths)),
    )[..., None, None]
    Jl_inv = np.eye(3) + 0.5 * W + c * W2
    J = -Jl_inv @ np.asarray(J_R_bg, np.float64)            # (K, 3, 3)
    w = np.asarray(valid, np.float64)
    H = np.einsum("kij,k,kil->jl", J, w, J)
    b = np.einsum("kij,k,ki->j", J, w, r)
    dbg = np.linalg.solve(H + 1e-9 * np.eye(3), -b)
    rms = np.sqrt((w * (r * r).sum(-1)).sum() / max(w.sum(), 1.0))
    return dbg, rms
