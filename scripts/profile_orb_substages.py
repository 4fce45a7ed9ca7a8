"""Per-substage device timing of the ORB orient+BRIEF path.

Breaks the fused orient_and_brief stage into its device substages:

  1. patch pull      — vmapped dynamic_slice 46x46 gather per keypoint
  2. orientation     — intensity-centroid einsum over the 31x31 disc
  3. in-patch blur   — separable 7x7 shift-add (46x46 -> 40x40)
  4. brief samples   — 30 unrolled static column-takes + where-accumulate
  5. brief as matmul — candidate matmul reformulation: one (N,1600)@(1600,7680)
                       +/-1 selection matmul + per-row bin pick

Run on the device:  python scripts/profile_orb_substages.py
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

from snakeslam_tpu.ops import orb


def timeit(fn, *args, reps=20):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3, out


def main():
    B, H, W = 8, 480, 752
    N = 400  # keypoints per frame at level 0
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(rng.uniform(0, 255, size=(B, H, W)).astype(np.float32))
    uv = jnp.asarray(
        rng.uniform([20, 20], [W - 20, H - 20], size=(B, N, 2))
        .astype(np.float32))

    # --- 1. patch pull ---------------------------------------------------
    @jax.jit
    def pull(imgs, uv):
        return jax.vmap(lambda im, u: orb._extract_patches(
            im, u, orb._BRIEF_SRC))(imgs, uv)

    ms, src = timeit(pull, imgs, uv)
    print(f"patch pull (46x46 x {B}x{N}): {ms:.3f} ms")

    # --- 2. orientation ----------------------------------------------------
    @jax.jit
    def orient(src):
        c = src[:, :, orb._CENTER_OFF:orb._CENTER_OFF + orb._PATCH,
                orb._CENTER_OFF:orb._CENTER_OFF + orb._PATCH]
        wx = jnp.asarray(orb._disc_x * orb._DISC_MASK)
        wy = jnp.asarray(orb._disc_y * orb._DISC_MASK)
        m10 = jnp.einsum("bnij,ij->bn", c, wx)
        m01 = jnp.einsum("bnij,ij->bn", c, wy)
        a = jnp.degrees(jnp.arctan2(m01, m10))
        return jnp.where(a < 0, a + 360.0, a)

    ms, ang = timeit(orient, src)
    print(f"orientation: {ms:.3f} ms")

    # --- 3. blur ------------------------------------------------------------
    @jax.jit
    def blur(src):
        return jax.vmap(orb._box_blur_patches)(src)

    ms, blurred = timeit(blur, src)
    print(f"in-patch 7x7 blur: {ms:.3f} ms")

    flat = blurred.reshape(B, N, orb._BRIEF_PATCH * orb._BRIEF_PATCH)

    # --- 4. current brief sampling ------------------------------------------
    @jax.jit
    def brief_now(flat, ang):
        return jax.vmap(orb._brief_from_patches)(flat, ang)

    ms, bits_now = timeit(brief_now, flat, ang)
    print(f"brief samples (30 static takes): {ms:.3f} ms")

    # --- 5. matmul brief ------------------------------------------------------
    # D: (1600, 30*256) with +1 at endpoint1, -1 at endpoint0 per (bin, bit)
    offs = orb._BRIEF_OFFSETS  # (30, 512): [end0 x256, end1 x256]
    nbins, nbits = offs.shape[0], offs.shape[1] // 2
    D = np.zeros((orb._BRIEF_PATCH * orb._BRIEF_PATCH, nbins * nbits),
                 dtype=np.float32)
    for b in range(nbins):
        cols = b * nbits + np.arange(nbits)
        np.add.at(D, (offs[b, nbits:], cols), 1.0)   # endpoint1
        np.add.at(D, (offs[b, :nbits], cols), -1.0)  # endpoint0
    Dj = jnp.asarray(D)

    @jax.jit
    def brief_mm(flat, ang):
        bin_ = jnp.round(ang * (nbins / 360.0)).astype(jnp.int32) % nbins
        d = jnp.einsum("bnf,fc->bnc", flat, Dj,
                       preferred_element_type=jnp.float32)
        d = d.reshape(*d.shape[:2], nbins, nbits)
        d = jnp.take_along_axis(d, bin_[..., None, None], axis=2)[..., 0, :]
        return (d > 0).astype(jnp.int8)

    ms, bits_mm = timeit(brief_mm, flat, ang)
    agree = float(jnp.mean((bits_mm == bits_now).astype(jnp.float32)))
    print(f"brief samples (+/-1 matmul): {ms:.3f} ms  "
          f"(bit agreement {agree:.6f})")

    # --- 5b. matmul brief, one-hot bin pick (no take_along_axis) -----------
    @jax.jit
    def brief_mm_oh(flat, ang):
        bin_ = jnp.round(ang * (nbins / 360.0)).astype(jnp.int32) % nbins
        oh = jax.nn.one_hot(bin_, nbins, dtype=flat.dtype)  # (B,N,30)
        d = jnp.einsum("bnf,fc->bnc", flat, Dj,
                       preferred_element_type=jnp.float32)
        d = d.reshape(*d.shape[:2], nbins, nbits)
        d = jnp.einsum("bnks,bnk->bns", d, oh)
        return (d > 0).astype(jnp.int8)

    ms, bits_oh = timeit(brief_mm_oh, flat, ang)
    agree = float(jnp.mean((bits_oh == bits_now).astype(jnp.float32)))
    print(f"brief samples (matmul + one-hot): {ms:.3f} ms  "
          f"(bit agreement {agree:.6f})")

    # --- 5c. small matmul: one-hot FIRST, then per-row (1600,512) gather ---
    # samples_n = patches_n @ S where S = sum_b onehot_b * S_b is per-row;
    # instead contract the one-hot into the offsets' one-hot tensor is too
    # big — skip; instead fold one-hot into patches: for each bin, mask rows.
    @jax.jit
    def brief_masked(flat, ang):
        bin_ = jnp.round(ang * (nbins / 360.0)).astype(jnp.int32) % nbins
        acc = jnp.zeros((*flat.shape[:2], nbits), dtype=flat.dtype)
        for b in range(nbins):
            sel = (bin_ == b).astype(flat.dtype)[..., None]
            d = jnp.einsum("bnf,fc->bnc", flat * sel,
                           Dj[:, b * nbits:(b + 1) * nbits],
                           preferred_element_type=jnp.float32)
            acc = acc + d
        return (acc > 0).astype(jnp.int8)

    ms, bits_mk = timeit(brief_masked, flat, ang)
    agree = float(jnp.mean((bits_mk == bits_now).astype(jnp.float32)))
    print(f"brief samples (30 masked matmuls): {ms:.3f} ms  "
          f"(bit agreement {agree:.6f})")

    # --- whole fused stage as shipped ---------------------------------------
    @jax.jit
    def fused(imgs, uv):
        return jax.vmap(orb.orient_and_brief)(imgs, uv)

    ms, _ = timeit(fused, imgs, uv)
    print(f"orient_and_brief fused total: {ms:.3f} ms")


if __name__ == "__main__":
    main()
