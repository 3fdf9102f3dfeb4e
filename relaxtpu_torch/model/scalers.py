"""Feature preprocessing: mean imputation + min-max scaling (own copy of
``relaxtpu/model/scalers.py:17-67``; numpy only).

The reference's sklearn SimpleImputer(mean) + MinMaxScaler pair is a NaN
fill followed by an affine map, kept here as three vectors.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FeatureScaler:
    """fill -> (x * scale + offset); sklearn-compatible semantics."""

    fill: np.ndarray  # imputer column means
    scale: np.ndarray  # min-max (max-min) reciprocal, zero range -> 1
    offset: np.ndarray  # -min * scale

    @classmethod
    def from_sklearn(cls, imputer, scaler) -> "FeatureScaler":
        """Wrap fitted sklearn objects (e.g. joblib-loaded reference pkls)."""
        return cls(
            fill=np.asarray(imputer.statistics_, np.float64),
            scale=np.asarray(scaler.scale_, np.float64),
            offset=np.asarray(scaler.min_, np.float64),
        )

    @classmethod
    def load_reference_pkls(cls, imputer_path: str, scaler_path: str) -> "FeatureScaler":
        import joblib  # the card's host has no joblib; only this loader needs it

        return cls.from_sklearn(joblib.load(imputer_path), joblib.load(scaler_path))

    def transform(self, x: np.ndarray) -> np.ndarray:
        x = np.array(x, dtype=np.float64, copy=True)
        nan = np.isnan(x)
        if nan.any():
            x[nan] = np.broadcast_to(self.fill, x.shape)[nan]
        return x * self.scale + self.offset
