"""Identity transform (reference: v2/transform/NullTransform.go)."""

from __future__ import annotations

import numpy as np

from .base import Transform


class NullTransform(Transform):
    name = "NONE"

    def forward(self, src: np.ndarray) -> np.ndarray:
        return src

    def inverse(self, src: np.ndarray) -> np.ndarray:
        return src
