"""Dataset shim for the FL scenario suite: seeded synthetic data + an
optional MNIST-format loader.

Fixed-seed reproducibility is the whole point: the scenario's accuracy-
vs-rounds record (docs/federated.md) is only a regression signal if the
data, the shards and the evaluation set are bit-identical run to run. So
the synthetic generator is a pure function of its seed, and sharding is
a seeded permutation — no globals, no wall clock.

The MNIST loader reads the classic IDX files (the format LeCun's site
and every mirror ship: ``train-images-idx3-ubyte`` etc., optionally
gzipped) from a local directory. It never downloads anything — the
container has no business fetching datasets mid-drill; point
``--fl-mnist`` at a directory you provisioned.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["synthetic_classification", "shard_dataset", "load_mnist_idx",
           "apply_backdoor_trigger", "backdoor_success_rate"]

#: the class a backdoor trigger steers predictions toward (fixed: the
#: attack's target must be identical across runs for the A/B to compare)
BACKDOOR_TARGET_CLASS = 0

#: trigger pixel value, deliberately outside the data's natural range
#: ([0,1] MNIST, ~[-5,5] synthetic tails) so the trigger is a usable
#: feature for the attacker's local training
BACKDOOR_TRIGGER_VALUE = 3.0


def synthetic_classification(
    train_size: int,
    eval_size: int,
    *,
    classes: int = 10,
    image_shape: Tuple[int, ...] = (28, 28, 1),
    seed: int = 0,
    signal: float = 2.0,
    noise: float = 1.0,
):
    """Seeded class-prototype classification data, image-shaped.

    Each class gets a fixed random prototype image (unit RMS); a sample
    is ``signal * prototype + noise * gaussian``. Labels are balanced.
    Linearly separable at the default signal-to-noise — a LeNet or a
    logistic head reaches high accuracy within a few FedAvg rounds,
    which is what makes "rounds to target accuracy" a stable headline.

    Returns ``(train_x, train_y, eval_x, eval_y)`` with float32 images
    and int32 labels; train and eval are drawn from the same seeded
    stream (eval last), so growing ``train_size`` never reshuffles the
    evaluation set for a fixed seed.
    """
    if train_size < 1 or eval_size < 1:
        raise ValueError("train_size and eval_size must be >= 1")
    rng = np.random.default_rng([seed, 0xF1])
    prototypes = rng.normal(size=(classes,) + tuple(image_shape))
    prototypes /= np.sqrt(np.mean(prototypes ** 2, axis=tuple(
        range(1, prototypes.ndim)), keepdims=True))
    total = train_size + eval_size
    labels = np.arange(total, dtype=np.int32) % classes
    rng.shuffle(labels)
    x = (signal * prototypes[labels]
         + noise * rng.normal(size=(total,) + tuple(image_shape)))
    x = x.astype(np.float32)
    return (x[:train_size], labels[:train_size],
            x[train_size:], labels[train_size:])


def shard_dataset(x, y, devices: int, *, seed: int = 0) -> List[tuple]:
    """Seeded IID partition of ``(x, y)`` into ``devices`` local shards.

    A seeded permutation deals examples round-robin, so every device
    gets ``len(x) // devices`` examples (the remainder is dropped — equal
    shard shapes keep ``LocalTrainer`` at ONE compiled program for the
    whole population). Returns ``[(x_i, y_i), ...]``.
    """
    if devices < 1:
        raise ValueError("devices must be >= 1")
    per = len(x) // devices
    if per < 1:
        raise ValueError(
            f"{len(x)} examples cannot shard across {devices} devices")
    order = np.random.default_rng([seed, 0x5A]).permutation(len(x))
    shards = []
    for d in range(devices):
        idx = order[d * per:(d + 1) * per]
        shards.append((x[idx], y[idx]))
    return shards


def apply_backdoor_trigger(x, trigger_dim: int,
                           value: float = BACKDOOR_TRIGGER_VALUE):
    """Stamp the backdoor trigger onto a batch of images: set ONE flat
    pixel index (``trigger_dim``, wrapped into range and unraveled into
    the image shape) to ``value`` on a copy of ``x``.

    The classic single-pixel backdoor (Gu et al., BadNets): an attacker
    trains on trigger-stamped inputs relabeled to
    ``BACKDOOR_TARGET_CLASS``, and attack success is measured by
    stamping the EVAL set (:func:`backdoor_success_rate`). A flat index
    keeps the knob one integer (``--poison-kind backdoor:DIM``) across
    image shapes."""
    x = np.array(x, copy=True)
    if x.ndim < 2 or x[0].size == 0:
        raise ValueError("apply_backdoor_trigger needs [batch, ...] images")
    pixel = np.unravel_index(int(trigger_dim) % x[0].size, x.shape[1:])
    x[(slice(None),) + pixel] = np.asarray(value, dtype=x.dtype)
    return x


def backdoor_success_rate(predict_fn, eval_x, eval_y,
                          trigger_dim: int) -> float:
    """Attack success rate of a backdoor: the fraction of trigger-stamped
    eval inputs the model classifies as ``BACKDOOR_TARGET_CLASS``,
    measured over inputs whose TRUE label is a different class (samples
    already of the target class cannot witness a flip). ``predict_fn``
    maps a batch of images to int class predictions. Returns 0.0 when no
    eligible samples exist."""
    eval_y = np.asarray(eval_y)
    eligible = eval_y != BACKDOOR_TARGET_CLASS
    if not int(eligible.sum()):
        return 0.0
    stamped = apply_backdoor_trigger(np.asarray(eval_x)[eligible],
                                     trigger_dim)
    predictions = np.asarray(predict_fn(stamped))
    return float(np.mean(predictions == BACKDOOR_TARGET_CLASS))


def _read_idx(path: str) -> np.ndarray:
    """One IDX file (optionally ``.gz``) -> ndarray (the format's own
    dtype/shape header; images uint8 [n, r, c], labels uint8 [n])."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        if magic >> 8 != 0x08 or ndim not in (1, 3):
            raise ValueError(f"{path}: not an IDX ubyte file "
                             f"(magic 0x{magic:08x})")
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    if data.size != int(np.prod(shape)):
        raise ValueError(f"{path}: truncated IDX payload "
                         f"({data.size} bytes for shape {shape})")
    return data.reshape(shape)


def _find_idx(directory: str, stem: str) -> Optional[str]:
    for name in (stem, stem + ".gz"):
        path = os.path.join(directory, name)
        if os.path.exists(path):
            return path
    return None


def load_mnist_idx(directory: str, *, limit: Optional[int] = None,
                   eval_limit: Optional[int] = None):
    """Load MNIST-format IDX files from ``directory``.

    Expects the four classic files (``train-images-idx3-ubyte``,
    ``train-labels-idx1-ubyte``, ``t10k-images-idx3-ubyte``,
    ``t10k-labels-idx1-ubyte``), plain or gzipped. Returns
    ``(train_x, train_y, eval_x, eval_y)`` with images scaled to
    ``[0, 1]`` float32 ``[n, 28, 28, 1]`` and int32 labels —
    drop-in for :func:`synthetic_classification`. ``limit`` /
    ``eval_limit`` truncate (drills do not need 60k images).
    """
    stems = {
        "train_x": "train-images-idx3-ubyte",
        "train_y": "train-labels-idx1-ubyte",
        "eval_x": "t10k-images-idx3-ubyte",
        "eval_y": "t10k-labels-idx1-ubyte",
    }
    paths = {}
    for key, stem in stems.items():
        path = _find_idx(directory, stem)
        if path is None:
            raise FileNotFoundError(
                f"MNIST IDX file {stem}[.gz] not found under {directory!r} "
                "(provision the four classic files; nothing is downloaded)")
        paths[key] = path

    def images(path, n):
        raw = _read_idx(path)
        if raw.ndim != 3:
            raise ValueError(f"{path}: expected an images file")
        raw = raw[:n] if n else raw
        return (raw.astype(np.float32) / 255.0)[..., None]

    def labels(path, n):
        raw = _read_idx(path)
        if raw.ndim != 1:
            raise ValueError(f"{path}: expected a labels file")
        return (raw[:n] if n else raw).astype(np.int32)

    train_x = images(paths["train_x"], limit)
    train_y = labels(paths["train_y"], limit)
    eval_x = images(paths["eval_x"], eval_limit)
    eval_y = labels(paths["eval_y"], eval_limit)
    if len(train_x) != len(train_y) or len(eval_x) != len(eval_y):
        raise ValueError("MNIST images/labels length mismatch")
    return train_x, train_y, eval_x, eval_y
