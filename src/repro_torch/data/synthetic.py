"""Deterministic synthetic datasets (offline container — no downloads).

Image tasks mirror the paper's benchmarks in shape and difficulty ordering:
  emnist-like  : 28x28x1, 47 classes  (paper: EMNIST  -> LeNet-5)
  cifar-like   : 32x32x3, 10 classes  (paper: CIFAR-10 -> ResNet-18)
  cinic-like   : 32x32x3, 10 classes, 3x samples, lower separability
                 (paper: CINIC-10 -> VGG-16)

Each class is a Gaussian cluster around a random template with additive
structured noise, so models genuinely *learn* (accuracy-vs-time curves are
informative) while remaining CPU-cheap.  `difficulty` scales the noise.
"""
from __future__ import annotations

import numpy as np


def make_image_dataset(name: str = "emnist-like", n_train: int = 6000,
                       n_test: int = 1000, img: int | None = None,
                       channels: int | None = None,
                       n_classes: int | None = None,
                       difficulty: float | None = None, seed: int = 0):
    presets = {
        "emnist-like": dict(img=28, channels=1, n_classes=47, difficulty=1.0),
        "cifar-like": dict(img=32, channels=3, n_classes=10, difficulty=1.6),
        "cinic-like": dict(img=32, channels=3, n_classes=10, difficulty=2.2),
        "tiny": dict(img=8, channels=1, n_classes=10, difficulty=0.8),
    }
    p = presets[name].copy()
    if img: p["img"] = img
    if channels: p["channels"] = channels
    if n_classes: p["n_classes"] = n_classes
    if difficulty: p["difficulty"] = difficulty

    rng = np.random.default_rng(seed)
    C, H, ch, diff = p["n_classes"], p["img"], p["channels"], p["difficulty"]
    templates = rng.normal(0, 1, (C, H, H, ch)).astype(np.float32)
    # low-frequency structure: smooth templates to make classes overlap
    for _ in range(2):
        templates = 0.5 * templates + 0.25 * (
            np.roll(templates, 1, 1) + np.roll(templates, 1, 2))

    def sample(n, seed_off):
        r = np.random.default_rng(seed + seed_off)
        y = r.integers(0, C, n)
        x = templates[y] + diff * r.normal(0, 1, (n, H, H, ch)).astype(np.float32)
        return {"x": x.astype(np.float32), "y": y.astype(np.int32)}

    return sample(n_train, 1), sample(n_test, 2), p


def make_lm_dataset(vocab_size: int, seq_len: int, n_seqs: int,
                    seed: int = 0, order: int = 2):
    """Synthetic Markov-chain token streams (learnable bigram structure)."""
    rng = np.random.default_rng(seed)
    # sparse bigram transition table: each token has few likely successors
    succ = rng.integers(0, vocab_size, (vocab_size, 4))
    tokens = np.empty((n_seqs, seq_len + 1), np.int32)
    state = rng.integers(0, vocab_size, n_seqs)
    for t in range(seq_len + 1):
        tokens[:, t] = state
        pick = rng.integers(0, 4, n_seqs)
        nxt = succ[state, pick]
        noise = rng.random(n_seqs) < 0.1
        state = np.where(noise, rng.integers(0, vocab_size, n_seqs), nxt)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


DATASETS = {
    "emnist-like": ("lenet5", dict(num_classes=47, in_channels=1, img=28)),
    "cifar-like": ("resnet18", dict(num_classes=10, in_channels=3)),
    "cinic-like": ("vgg16", dict(num_classes=10, in_channels=3)),
    "tiny": ("lenet5_small", dict(num_classes=10, in_channels=1, img=8)),
}
