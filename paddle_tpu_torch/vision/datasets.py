"""Vision datasets (counterpart of paddle_tpu/vision/datasets.py, cut to
FakeData; the file-backed sets wait, ROADMAP queue 1)."""
from __future__ import annotations

import numpy as np

from ..io import Dataset


class FakeData(Dataset):
    """Seeded synthetic labelled images (CIFAR-shaped by default), bitwise
    the reference's: HWC uint8 images from RandomState(seed), labels the
    argmax of a random linear map of each image's mean channel values,
    so that they can be learnt. Samples are (transform(image), label)."""

    def __init__(self, num_samples=1024, image_shape=(3, 32, 32),
                 num_classes=10, transform=None, seed=0):
        rng = np.random.RandomState(seed)
        self.images = rng.randint(
            0, 256, (num_samples, *image_shape[1:], image_shape[0]),
            dtype=np.uint8)
        feats = self.images.reshape(num_samples, -1, image_shape[0]).mean(1)
        w = rng.randn(num_classes, image_shape[0])
        self.labels = (feats @ w.T).argmax(1).astype("int64")
        self.transform = transform

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


__all__ = ["FakeData"]
