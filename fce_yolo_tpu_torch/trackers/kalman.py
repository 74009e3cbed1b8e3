"""Kalman filter for box tracking (reference ``fce_yolo_tpu/trackers/kalman.py:16``).

Constant velocity on the 8-dim state (cx, cy, aspect, h and their
velocities), measured as (cx, cy, a, h); the process and measurement
noise scale with the box height. numpy float64 on the host: the state is 8
numbers a track, so the card would only add copies. ``multi_predict``
predicts all tracks at once.
"""

from __future__ import annotations

import numpy as np

__all__ = ["KalmanFilterXYAH"]


class KalmanFilterXYAH:
    def __init__(self):
        ndim, dt = 4, 1.0
        self._motion_mat = np.eye(2 * ndim)
        for i in range(ndim):
            self._motion_mat[i, ndim + i] = dt
        self._update_mat = np.eye(ndim, 2 * ndim)
        self._std_weight_position = 1.0 / 20
        self._std_weight_velocity = 1.0 / 160

    def initiate(self, measurement: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Create track state from an unmatched measurement (cx, cy, a, h)."""
        mean = np.concatenate([measurement, np.zeros(4)])
        h = measurement[3]
        std = [
            2 * self._std_weight_position * h,
            2 * self._std_weight_position * h,
            1e-2,
            2 * self._std_weight_position * h,
            10 * self._std_weight_velocity * h,
            10 * self._std_weight_velocity * h,
            1e-5,
            10 * self._std_weight_velocity * h,
        ]
        return mean, np.diag(np.square(std))

    def predict(self, mean: np.ndarray, covariance: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        h = mean[3]
        std_pos = [self._std_weight_position * h] * 2 + [1e-2, self._std_weight_position * h]
        std_vel = [self._std_weight_velocity * h] * 2 + [1e-5, self._std_weight_velocity * h]
        motion_cov = np.diag(np.square(std_pos + std_vel))
        mean = self._motion_mat @ mean
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + motion_cov
        return mean, covariance

    def multi_predict(self, mean: np.ndarray, covariance: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized predict over N tracks: mean (N, 8), covariance (N, 8, 8)."""
        h = mean[:, 3]
        std = np.stack(
            [
                self._std_weight_position * h,
                self._std_weight_position * h,
                np.full_like(h, 1e-2),
                self._std_weight_position * h,
                self._std_weight_velocity * h,
                self._std_weight_velocity * h,
                np.full_like(h, 1e-5),
                self._std_weight_velocity * h,
            ],
            axis=1,
        )
        motion_cov = np.square(std)[:, :, None] * np.eye(8)[None]
        mean = mean @ self._motion_mat.T
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + motion_cov
        return mean, covariance

    def update(self, mean: np.ndarray, covariance: np.ndarray,
               measurement: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Kalman correction step with a new measurement."""
        h = mean[3]
        std = [
            self._std_weight_position * h,
            self._std_weight_position * h,
            1e-1,
            self._std_weight_position * h,
        ]
        innovation_cov = np.diag(np.square(std))
        projected_mean = self._update_mat @ mean
        projected_cov = self._update_mat @ covariance @ self._update_mat.T + innovation_cov

        # gain via Cholesky solve (projected_cov is SPD)
        chol = np.linalg.cholesky(projected_cov)
        b = (covariance @ self._update_mat.T).T
        kalman_gain = np.linalg.solve(chol.T, np.linalg.solve(chol, b)).T
        innovation = measurement - projected_mean
        new_mean = mean + kalman_gain @ innovation
        new_cov = covariance - kalman_gain @ projected_cov @ kalman_gain.T
        return new_mean, new_cov
