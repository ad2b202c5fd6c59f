# Copied from src/repro/data/synthetic.py (the whole file).
"""Synthetic data: procedural "conveyor-belt toys" images + token streams.

No datasets ship offline, so the paper's CIFAR10/ICE-Lab images are stood
in for by a *learnable* procedural shape-classification task (the paper's
own task is classifying toy shapes on a conveyor belt, §V): each class is
a geometric silhouette (disk, square, cross, ring, triangle, stripes, ...)
rendered at random position/scale with noise and background clutter.  A
VGG reaches >90% on it within a few hundred CPU steps, which is what the
accuracy-vs-split experiments need.

Token streams for LM training are Zipf-sampled with a deterministic
next-token structure so cross-entropy visibly falls.
"""
from __future__ import annotations

import numpy as np

N_TOY_CLASSES = 8


def _render(cls: int, hw: int, rng: np.random.Generator) -> np.ndarray:
    img = rng.normal(0.0, 0.15, (hw, hw, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:hw, 0:hw]
    cy, cx = rng.integers(hw // 4, 3 * hw // 4, 2)
    r = rng.integers(hw // 6, hw // 3)
    color = rng.uniform(0.6, 1.0, 3).astype(np.float32)
    if cls == 0:    # disk
        m = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    elif cls == 1:  # square
        m = (np.abs(yy - cy) <= r) & (np.abs(xx - cx) <= r)
    elif cls == 2:  # ring
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        m = (d2 <= r * r) & (d2 >= (r // 2) ** 2)
    elif cls == 3:  # cross
        m = (np.abs(yy - cy) <= r // 3) | (np.abs(xx - cx) <= r // 3)
        m &= (np.abs(yy - cy) <= r) & (np.abs(xx - cx) <= r)
    elif cls == 4:  # triangle
        m = (yy - cy >= -r) & (yy - cy <= r) & (np.abs(xx - cx) <= (yy - cy + r) // 2)
    elif cls == 5:  # horizontal stripes
        m = ((yy // max(2, r // 2)) % 2 == 0) & (np.abs(yy - cy) <= r) & (np.abs(xx - cx) <= r)
    elif cls == 6:  # diamond
        m = np.abs(yy - cy) + np.abs(xx - cx) <= r
    else:           # checker
        m = (((yy // max(2, r // 2)) + (xx // max(2, r // 2))) % 2 == 0)
        m &= (np.abs(yy - cy) <= r) & (np.abs(xx - cx) <= r)
    img[m] = img[m] * 0.2 + color
    return np.clip(img, -1.0, 2.0)


def toy_images(n: int, hw: int = 32, seed: int = 0,
               n_classes: int = N_TOY_CLASSES) -> tuple:
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, n_classes, n)
    xs = np.stack([_render(int(c), hw, rng) for c in ys])
    return xs.astype(np.float32), ys.astype(np.int32)


def toy_image_iter(batch: int, hw: int = 32, seed: int = 0,
                   n_classes: int = N_TOY_CLASSES):
    i = 0
    while True:
        xs, ys = toy_images(batch, hw, seed + i, n_classes)
        yield xs, ys
        i += 1


def token_batch(batch: int, seq: int, vocab: int, seed: int = 0) -> dict:
    """Zipf-ish stream with learnable bigram structure: next = (5*t+7) % V
    half the time, noise otherwise."""
    rng = np.random.default_rng(seed)
    toks = np.empty((batch, seq + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, batch)
    noise = rng.random((batch, seq))
    rand = rng.integers(0, vocab, (batch, seq))
    for t in range(seq):
        det = (5 * toks[:, t] + 7) % vocab
        toks[:, t + 1] = np.where(noise[:, t] < 0.8, det, rand[:, t])
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def token_iter(batch: int, seq: int, vocab: int, seed: int = 0):
    i = 0
    while True:
        yield token_batch(batch, seq, vocab, seed + i)
        i += 1
