"""Point-cloud augmentation transforms (host-side numpy), the port of
pcf_tpu/data/transforms.py: the same classes, functions and draws.

Functional re-implementation of the reference's transforms.py:17-325 with the
same composition protocol: each transform maps (coords, feats, labels, norms)
-> (coords, feats, labels, norms). Only RandomDropColor (and NoisyPoints, on
cfg.noisy_points) is wired into the ScanNet loader; the rest are provided for
config parity. All randomness flows through an explicit numpy Generator.
"""

from __future__ import annotations

import numpy as np
import scipy.interpolate
import scipy.ndimage


class Compose:
    """Chain transforms (reference: transforms.py:17-34)."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, *args):
        for t in self.transforms:
            args = t(*args)
        return args


class RandomDropColor:
    """With prob (1-p) scale colors by color_augment (0 = drop entirely)
    (reference: transforms.py:37-67 — note the reference applies the drop when
    rand() > p with p=0.8, i.e. 20% of the time)."""

    def __init__(self, p=0.8, color_augment=0.0, rng=None):
        self.p = p
        self.color_augment = color_augment
        self.rng = rng or np.random.default_rng()

    def __call__(self, coords, color, labels, norms):
        if color is not None and self.rng.random() > self.p:
            color = color * self.color_augment
        return coords, color, labels, norms


class RandomDropout:
    """Randomly drop dropout_ratio of the points (reference: transforms.py:70-96)."""

    def __init__(self, dropout_ratio=0.2, dropout_application_ratio=0.5, rng=None):
        self.dropout_ratio = dropout_ratio
        self.dropout_application_ratio = dropout_application_ratio
        self.rng = rng or np.random.default_rng()

    def __call__(self, coords, feats, labels, norms):
        if self.rng.random() < self.dropout_application_ratio:
            n = len(coords)
            inds = self.rng.choice(n, int(n * (1 - self.dropout_ratio)), replace=False)
            return coords[inds], feats[inds], labels[inds], norms[inds]
        return coords, feats, labels, norms


class RandomHorizontalFlip:
    """Flip each non-upright axis with probability axis_flip_likelihood
    (reference: transforms.py:99-135). Flips coords AND normals."""

    def __init__(self, upright_axis="z", apply_likelihood=0.95,
                 axis_flip_likelihood=0.5, rng=None):
        self.upright_axis = {"x": 0, "y": 1, "z": 2}[upright_axis.lower()]
        self.apply_likelihood = apply_likelihood
        self.axis_flip_likelihood = axis_flip_likelihood
        self.horz_axes = sorted(set(range(3)) - {self.upright_axis})
        self.rng = rng or np.random.default_rng()

    def __call__(self, coords, feats, labels, norms):
        if self.rng.random() < self.apply_likelihood:
            for ax in self.horz_axes:
                if self.rng.random() < self.axis_flip_likelihood:
                    coords[:, ax] = -coords[:, ax]
                    norms[:, ax] = -norms[:, ax]
        return coords, feats, labels, norms


class ChromaticTranslation:
    """Global random color shift, clipped to [0,255] (reference: transforms.py:138-166)."""

    def __init__(self, trans_range_ratio=0.1, apply_likelihood=0.95, rng=None):
        self.trans_range_ratio = trans_range_ratio
        self.apply_likelihood = apply_likelihood
        self.rng = rng or np.random.default_rng()

    def __call__(self, coords, feats, labels, norms):
        if self.rng.random() < self.apply_likelihood:
            tr = (self.rng.random((1, 3)) - 0.5) * 255 * 2 * self.trans_range_ratio
            feats[:, :3] = np.clip(tr + feats[:, :3], 0, 255)
        return coords, feats, labels, norms


class ChromaticAutoContrast:
    """Blend with a min-max contrast-stretched version (reference: transforms.py:169-207)."""

    def __init__(self, randomize_blend_factor=True, blend_factor=0.5, rng=None):
        self.randomize_blend_factor = randomize_blend_factor
        self.blend_factor = blend_factor
        self.rng = rng or np.random.default_rng()

    def __call__(self, coords, feats, labels, norms):
        if self.rng.random() < 0.2:
            lo = feats[:, :3].min(0, keepdims=True)
            hi = feats[:, :3].max(0, keepdims=True)
            scale = 255 / np.maximum(hi - lo, 1e-8)
            contrast = (feats[:, :3] - lo) * scale
            bf = self.rng.random() if self.randomize_blend_factor else self.blend_factor
            feats[:, :3] = (1 - bf) * feats[:, :3] + bf * contrast
        return coords, feats, labels, norms


class ChromaticJitter:
    """Per-point Gaussian color noise (reference: transforms.py:210-239)."""

    def __init__(self, std=0.01, apply_likelihood=0.95, rng=None):
        self.std = std
        self.apply_likelihood = apply_likelihood
        self.rng = rng or np.random.default_rng()

    def __call__(self, coords, feats, labels, norms):
        if self.rng.random() < self.apply_likelihood:
            noise = self.rng.normal(size=(feats.shape[0], 3)) * self.std * 255
            feats[:, :3] = np.clip(noise + feats[:, :3], 0, 255)
        return coords, feats, labels, norms


class NoisyPoints:
    """Robustness fault injection: replace a fraction of points with uniform
    noise labeled ignore (reference hook: scannet_data_loader_color_DDP.py:37-41)."""

    def __init__(self, noise_level=0.1, noise_pct=0.1, ignore_label=-100, rng=None):
        self.noise_level = noise_level
        self.noise_pct = noise_pct
        self.ignore_label = ignore_label
        self.rng = rng or np.random.default_rng()

    def __call__(self, coords, feats, labels, norms):
        n = coords.shape[0]
        n_noise = int(n * self.noise_pct)
        if n_noise == 0:
            return coords, feats, labels, norms
        lo, hi = coords.min(0), coords.max(0)
        noise_coords = self.rng.uniform(lo, hi, size=(n_noise, 3)).astype(coords.dtype)
        noise_feats = self.rng.uniform(-1, 1, size=(n_noise, feats.shape[1])).astype(feats.dtype)
        noise_norms = self.rng.normal(size=(n_noise, 3)).astype(norms.dtype)
        noise_norms /= np.linalg.norm(noise_norms, axis=1, keepdims=True)
        coords = np.concatenate([coords, noise_coords])
        feats = np.concatenate([feats, noise_feats])
        norms = np.concatenate([norms, noise_norms])
        labels = np.concatenate([labels, np.full(n_noise, self.ignore_label,
                                                 dtype=labels.dtype)])
        return coords, feats, labels, norms


def elastic_distortion(pointcloud, granularity, magnitude, rng=None):
    """Elastic distortion over a smoothed noise grid (reference: transforms.py:242-276)."""
    rng = rng or np.random.default_rng()
    blurs = [np.ones((3, 1, 1, 1), np.float32) / 3,
             np.ones((1, 3, 1, 1), np.float32) / 3,
             np.ones((1, 1, 3, 1), np.float32) / 3]
    coords = pointcloud[:, :3]
    coords_min = coords.min(0)
    noise_dim = ((coords - coords_min).max(0) // granularity).astype(int) + 3
    noise = rng.normal(size=(*noise_dim, 3)).astype(np.float32)
    for _ in range(2):
        for blur in blurs:
            noise = scipy.ndimage.convolve(noise, blur, mode="constant", cval=0)
    ax = [np.linspace(d_min, d_max, d)
          for d_min, d_max, d in zip(coords_min - granularity,
                                     coords_min + granularity * (noise_dim - 2),
                                     noise_dim)]
    interp = scipy.interpolate.RegularGridInterpolator(
        ax, noise, bounds_error=False, fill_value=0)
    pointcloud[:, :3] = coords + interp(coords) * magnitude
    return pointcloud


def rotation_matrix(axis: int, theta: float) -> np.ndarray:
    """Rotation about a coordinate axis (reference M(), transforms.py:280-281)."""
    a = np.zeros(3)
    a[axis] = 1.0
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def get_transformation_matrix(rotation_augmentation_bound,
                              scale_augmentation_bound,
                              rotation_angle=None, rng=None):
    """Random scale + rotation 4x4 matrices (reference: transforms.py:286-325)."""
    rng = rng or np.random.default_rng()
    scale_matrix = np.eye(4)
    rot = np.eye(4)
    mats = []
    for axis_ind, bound in enumerate(rotation_augmentation_bound):
        theta = rng.uniform(*bound) if bound is not None else 0.0
        mats.append(rotation_matrix(axis_ind, theta))
    rng.shuffle(mats)
    rot3 = mats[0] @ mats[1] @ mats[2]
    if rotation_angle is not None:
        rot3 = rotation_matrix(2, rotation_angle)
    rot[:3, :3] = rot3
    scale = rng.uniform(*np.atleast_1d(scale_augmentation_bound)) \
        if np.ndim(scale_augmentation_bound) else scale_augmentation_bound
    np.fill_diagonal(scale_matrix[:3, :3], scale)
    return scale_matrix, rot
