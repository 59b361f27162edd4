"""Packed per-pixel active-sample bitmask for iterative sample-reduction
training: one bit per depth cell of every pixel of every training image,
packed with numpy. Feeds the ``FromIterativeSamplePlacement`` z-sampler.

Counterpart of ``adanerf_tpu/utils/sample_placement_tracker.py``; its
``.npy`` files are read and written by either package.
"""

from __future__ import annotations

import numpy as np


class SamplePlacementTracker:
    def __init__(self, num_images, width, height, max_sample_count=128):
        self.max_sample_count = max_sample_count
        self.width = width
        self.height = height
        self.num_images = num_images
        self.bit_data = np.packbits(
            np.ones((num_images, height, width, max_sample_count), dtype=bool), axis=-1)

    def get_unpacked_image(self, index: int) -> np.ndarray:
        return np.unpackbits(self.bit_data[index]).reshape(
            [self.height, self.width, self.max_sample_count])

    # fixed placements of the iterative sample-placement tests
    def set_2_samples_test(self):
        self.bit_data[:, :, :, :] = np.array(
            [128, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1], np.uint8)

    def set_32_samples_test(self):
        self.bit_data[:, :, :, :] = np.array([128 + 8] * 16, np.uint8)

    def set_16_samples_test(self):
        self.bit_data[:, :, :, :] = np.array([128] * 16, np.uint8)

    def replace_samples_batch(self, samples, batch_0, image_index):
        """samples: (1, batch, max_sample_count) active flags."""
        batch_size = samples.shape[1]
        packed = np.packbits(np.asarray(samples).astype(bool), axis=-1)
        flat = self.bit_data[image_index].reshape(-1, self.bit_data.shape[-1])
        flat[batch_0:batch_0 + batch_size, :] = packed.squeeze()

    def save(self, path):
        np.save(path, self.bit_data)

    def load(self, path):
        self.bit_data = np.load(path)
