"""Feature preprocessing: mean imputation + min-max scaling (own copy of
``relaxtpu/model/scalers.py:17-67``; numpy only).

The reference's sklearn SimpleImputer(mean) + MinMaxScaler pair is a NaN
fill followed by an affine map, kept here as three vectors.  ``fit`` and
``fit_transform_like_reference`` run the JAX package's float64 operations
in its order, so their results are bit-identical to it.
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
    def fit(cls, x: np.ndarray) -> "FeatureScaler":
        """Fit like the reference's preprocess_data (nan/inf zeroed first)."""
        x = np.array(x, dtype=np.float64, copy=True)
        x[np.isnan(x)] = 0
        x[np.isinf(x)] = 0
        fill = x.mean(axis=0)
        dmin = x.min(axis=0)
        dmax = x.max(axis=0)
        rng = dmax - dmin
        rng[rng == 0.0] = 1.0  # sklearn's _handle_zeros_in_scale
        scale = 1.0 / rng
        return cls(fill=fill, scale=scale, offset=-dmin * scale)

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

    def fit_transform_like_reference(self, x: np.ndarray) -> np.ndarray:
        """preprocess_data semantics: zero nan/inf, impute, scale."""
        x = np.array(x, dtype=np.float64, copy=True)
        x[np.isnan(x)] = 0
        x[np.isinf(x)] = 0
        return self.transform(x)
