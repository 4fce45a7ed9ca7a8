"""Fused pose-GN kernel (Pallas, Triton route) vs the XLA
robust_pose_refine oracle.

The CPU tests run the kernel in the Pallas interpreter; the ``gpu`` tests
compile it for the card and skip where there is none."""

import numpy as np
import jax.numpy as jnp
import pytest

from snakeslam_tpu.ops.pose_pallas import padded_size, pose_refine_fused
from snakeslam_tpu.utils.pose_fixtures import (
    check_fused_parity,
    compare_fused_with_xla,
    make_pose_problem,
)


@pytest.mark.parametrize("stereo", [True, False])
def test_fused_matches_xla(stereo):
    check_fused_parity(compare_fused_with_xla(1024, stereo, interpret=True))


def test_fused_small_slot_count():
    T0, obs, cam, bf, T_gt = make_pose_problem(seed=9, N=512)
    T_f, _, n = pose_refine_fused(
        T0, obs.points, obs.uv, obs.right, obs.weight, obs.mask,
        cam, bf, outer_iters=2, inner_iters=2, interpret=True)
    err_t = np.linalg.norm(np.asarray(T_f)[:3, 3] - T_gt[:3, 3])
    assert err_t < 2e-3
    assert int(n) > 300


@pytest.mark.parametrize("n,want", [(1, 2), (512, 512), (1000, 1024),
                                    (1024, 1024), (1025, 2048),
                                    (2048, 2048)])
def test_padded_size_is_next_power_of_two(n, want):
    assert padded_size(n) == want


def test_fused_padding_matches_explicit_masked_slots():
    """N = 1000 pads to 1024 inside the wrapper; the same problem with the
    24 extra slots written out as masked zeros gives the identical pose
    and inliers."""
    T0, obs, cam, bf, _ = make_pose_problem(seed=5, N=1000)
    T_a, inl_a, n_a = pose_refine_fused(
        T0, obs.points, obs.uv, obs.right, obs.weight, obs.mask,
        cam, bf, interpret=True)
    pad = 24

    def z(x):
        return jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))

    T_b, inl_b, n_b = pose_refine_fused(
        T0, z(obs.points), z(obs.uv), z(obs.right), z(obs.weight),
        z(obs.mask), cam, bf, interpret=True)
    assert inl_a.shape == (1000,) and inl_b.shape == (1024,)
    assert np.array_equal(np.asarray(T_a), np.asarray(T_b))
    assert np.array_equal(np.asarray(inl_a), np.asarray(inl_b)[:1000])
    assert not np.asarray(inl_b)[1000:].any()
    assert int(n_a) == int(n_b)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1024, 2048])
@pytest.mark.parametrize("stereo", [True, False])
def test_fused_compiled_matches_xla(gpu, n, stereo):
    """The kernel compiled for the card (no interpreter) against XLA."""
    check_fused_parity(compare_fused_with_xla(n, stereo, interpret=False))
