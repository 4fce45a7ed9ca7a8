"""Train the shipped ORB vocabulary on rendered synthetic imagery.

The reference loads a DBoW vocabulary trained on real images
(/root/reference/Snake/System/System.cpp:44).  This environment has no
image corpus, so the shipped tree is trained on descriptors extracted by
our own ORB front-end (ops/orb.py) from a few hundred rendered
corner-rich scenes — real ORB descriptor statistics (oriented rBRIEF over
intensity patches), not uniform random bits.  Output:
``snakeslam_tpu/data/orbvoc_synth.npz`` (k=10, levels=4, 10k words —
sized for the dense-vector matmul retrieval in loop/keyframe_database.py).

Run:  python scripts/train_vocab.py  [n_images]
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp

from snakeslam_tpu.ops import bow as BOW
from snakeslam_tpu.ops import orb as ORB


def render_scene(rng, H=480, W=640):
    """Corner-rich synthetic scene: blocks, ellipses, gradients, noise."""
    img = np.full((H, W), float(rng.integers(90, 170)), dtype=np.float32)
    # low-frequency illumination gradient
    gy = rng.uniform(-40, 40) / H
    gx = rng.uniform(-40, 40) / W
    img += np.arange(H)[:, None] * gy + np.arange(W)[None, :] * gx
    for _ in range(rng.integers(40, 90)):
        h = int(rng.integers(10, 80))
        w = int(rng.integers(10, 80))
        y = int(rng.integers(0, H - h))
        x = int(rng.integers(0, W - w))
        val = float(rng.integers(30, 230))
        if rng.random() < 0.3:
            yy, xx = np.mgrid[0:h, 0:w]
            mask = (((yy - h / 2) / (h / 2)) ** 2
                    + ((xx - w / 2) / (w / 2)) ** 2) <= 1.0
            img[y:y + h, x:x + w][mask] = val
        else:
            img[y:y + h, x:x + w] = val
    img += rng.normal(0, 3.0, size=img.shape)
    return np.clip(img, 0, 255).astype(np.float32)


def main():
    n_images = int(sys.argv[1]) if len(sys.argv) > 1 else 80
    rng = np.random.default_rng(42)
    descs = []
    t0 = time.time()
    for i in range(n_images):
        img = render_scene(rng)
        feats = ORB.extract_orb(jnp.asarray(img), n_features=1000)
        valid = np.asarray(feats.valid)
        descs.append(np.asarray(feats.desc_bits)[valid].astype(np.int8))
        if (i + 1) % 10 == 0:
            print(f"{i + 1}/{n_images} images, "
                  f"{sum(len(x) for x in descs)} descriptors, "
                  f"{time.time() - t0:.0f}s", flush=True)
    train = np.concatenate(descs)
    print(f"training k=10 levels=4 on {len(train)} descriptors...",
          flush=True)
    voc = BOW.train_vocabulary(train, k=10, levels=4, seed=0)
    out = (Path(__file__).resolve().parent.parent
           / "snakeslam_tpu" / "data" / "orbvoc_synth.npz")
    out.parent.mkdir(parents=True, exist_ok=True)
    BOW.save_vocabulary(voc, out)
    # occupancy report: a healthy tree spreads mass over many words
    words, v = BOW.transform_packed_np(
        BOW.load_vocabulary(out),
        np.packbits(train[:5000].astype(np.uint8), axis=-1,
                    bitorder="little"))
    occ = len(np.unique(words))
    print(f"saved {out} ({out.stat().st_size / 1e6:.2f} MB); "
          f"5k sample hits {occ} distinct words of {voc.n_words}")


if __name__ == "__main__":
    main()
