"""Training-time augmentation on the host (numpy, scipy, native resampler).

A copy of ``segmamba_tpu/data/augment.py``. Each transform is a callable
``(batch_dict, rng) -> batch_dict`` on ``{'data': (B, C, Z, Y, X), 'seg':
(B, 1, Z, Y, X)}`` float32 batches. The default chain:

  SpatialTransform(rot +-30 deg p=.2, scale 0.7-1.4 p=.2, order 3/1, cval 0/-1)
  GaussianNoise(p=.1) -> GaussianBlur(sigma .5-1, p=.2, per-channel .5)
  BrightnessMultiplicative(.75-1.25, p=.15) -> Contrast(p=.15)
  SimulateLowRes(zoom .5-1, per-channel .5, p=.25)
  Gamma(.7-1.5, inverted, retain stats, p=.1)
  Gamma(.7-1.5, retain stats, p=.3)
  Mirror(axes 0,1,2) -> RemoveLabel(-1 -> 0)

The rotation/scaling resampler is ``native.affine_transform_3d``, as in
the JAX package: the C++ extension (order 3 by Catmull-Rom), or scipy's
B-spline when ``SEGMAMBA_DISABLE_NATIVE=1`` asks for it. One difference
from the JAX package, not in the numbers drawn from ``rng``: the chains
are ``functools.partial`` objects rather than closures, so that they
pickle to the loader's spawned worker processes.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy import ndimage

from segmamba_tpu_torch.native import affine_transform_3d


# -- individual transforms ---------------------------------------------------


def spatial_transform(batch, rng, p_rot=0.2, p_scale=0.2,
                      angle=np.deg2rad(30.0), scale_range=(0.7, 1.4),
                      order_data=3, order_seg=1):
    """Per-sample random rotation (all 3 axes) and isotropic scaling about
    the patch center; constant border 0 (data) / -1 (seg)."""
    data, seg = batch["data"], batch.get("seg")
    for b in range(data.shape[0]):
        do_rot = rng.uniform() < p_rot
        do_scale = rng.uniform() < p_scale
        if not (do_rot or do_scale):
            continue
        mat = np.eye(3)
        if do_rot:
            for ax in range(3):
                a = rng.uniform(-angle, angle)
                c, s = np.cos(a), np.sin(a)
                rot = np.eye(3)
                i, j = [k for k in range(3) if k != ax]
                rot[i, i], rot[i, j], rot[j, i], rot[j, j] = c, -s, s, c
                mat = rot @ mat
        sc = rng.uniform(*scale_range) if do_scale else 1.0
        mat = mat * sc
        center = (np.asarray(data.shape[2:]) - 1) / 2.0
        offset = center - mat @ center
        for c in range(data.shape[1]):
            data[b, c] = affine_transform_3d(
                data[b, c], mat, offset, order=order_data, cval=0.0)
        if seg is not None:
            for c in range(seg.shape[1]):
                seg[b, c] = affine_transform_3d(
                    seg[b, c], mat, offset, order=order_seg, cval=-1.0)
            np.rint(seg, out=seg)
    return batch


def gaussian_noise(batch, rng, p=0.1, variance=(0.0, 0.1)):
    data = batch["data"]
    for b in range(data.shape[0]):
        if rng.uniform() < p:
            var = rng.uniform(*variance)
            data[b] += rng.normal(0.0, np.sqrt(var),
                                  size=data[b].shape).astype(data.dtype)
    return batch


def gaussian_blur(batch, rng, p=0.2, p_channel=0.5, sigma=(0.5, 1.0)):
    data = batch["data"]
    for b in range(data.shape[0]):
        if rng.uniform() < p:
            for c in range(data.shape[1]):
                if rng.uniform() < p_channel:
                    data[b, c] = ndimage.gaussian_filter(
                        data[b, c], rng.uniform(*sigma))
    return batch


def brightness_multiplicative(batch, rng, p=0.15, rng_mult=(0.75, 1.25)):
    data = batch["data"]
    for b in range(data.shape[0]):
        if rng.uniform() < p:
            for c in range(data.shape[1]):
                data[b, c] *= rng.uniform(*rng_mult)
    return batch


def contrast(batch, rng, p=0.15, factor_range=(0.75, 1.25),
             preserve_range=True):
    data = batch["data"]
    for b in range(data.shape[0]):
        if rng.uniform() < p:
            for c in range(data.shape[1]):
                f = rng.uniform(*factor_range)
                x = data[b, c]
                mean, mn, mx = x.mean(), x.min(), x.max()
                x = (x - mean) * f + mean
                if preserve_range:
                    np.clip(x, mn, mx, out=x)
                data[b, c] = x
    return batch


def simulate_low_res(batch, rng, p=0.25, p_channel=0.5, zoom_range=(0.5, 1.0)):
    data = batch["data"]
    for b in range(data.shape[0]):
        if rng.uniform() < p:
            for c in range(data.shape[1]):
                if rng.uniform() < p_channel:
                    z = rng.uniform(*zoom_range)
                    small = ndimage.zoom(data[b, c], z, order=0)
                    back = ndimage.zoom(
                        small, np.asarray(data[b, c].shape) /
                        np.asarray(small.shape), order=3)
                    # guard off-by-one shape drift from rounding
                    sl = tuple(slice(0, s) for s in data[b, c].shape)
                    out = np.zeros_like(data[b, c])
                    src = tuple(slice(0, min(a, b2)) for a, b2 in
                                zip(data[b, c].shape, back.shape))
                    out[src] = back[src]
                    data[b, c] = out
    return batch


def gamma(batch, rng, p, gamma_range=(0.7, 1.5), invert_image=False,
          retain_stats=True, eps=1e-7):
    data = batch["data"]
    for b in range(data.shape[0]):
        if rng.uniform() >= p:
            continue
        for c in range(data.shape[1]):
            x = data[b, c]
            if invert_image:
                x = -x
            mean, std = x.mean(), x.std()
            if rng.uniform() < 0.5 and gamma_range[0] < 1:
                g = rng.uniform(gamma_range[0], 1.0)
            else:
                g = rng.uniform(max(gamma_range[0], 1.0), gamma_range[1])
            mn, rngv = x.min(), x.max() - x.min()
            x = np.power((x - mn) / max(rngv, eps), g) * rngv + mn
            if retain_stats:
                x = (x - x.mean()) / max(x.std(), 1e-8) * std + mean
            if invert_image:
                x = -x
            data[b, c] = x
    return batch


def mirror(batch, rng, axes=(0, 1, 2)):
    data, seg = batch["data"], batch.get("seg")
    for b in range(data.shape[0]):
        for ax in axes:
            if rng.uniform() < 0.5:
                data[b] = np.flip(data[b], axis=ax + 1)
                if seg is not None:
                    seg[b] = np.flip(seg[b], axis=ax + 1)
    return batch


def remove_label(batch, rng=None, src=-1, dst=0):
    if "seg" in batch:
        seg = batch["seg"]
        seg[seg == src] = dst
    return batch


# -- chains (train_augment.py variants) -------------------------------------


def _run_chain(fns, batch, rng):
    batch = dict(batch)
    batch["data"] = np.ascontiguousarray(batch["data"], np.float32)
    if "seg" in batch:
        batch["seg"] = np.ascontiguousarray(batch["seg"], np.float32)
    for fn in fns:
        batch = fn(batch, rng)
    return batch


def _chain(*fns):
    return functools.partial(_run_chain, fns)


def get_train_transforms(mirror_axes=(0, 1, 2)):
    fns = [
        spatial_transform,
        gaussian_noise,
        gaussian_blur,
        brightness_multiplicative,
        contrast,
        simulate_low_res,
        functools.partial(gamma, p=0.1, invert_image=True),
        functools.partial(gamma, p=0.3, invert_image=False),
    ]
    if mirror_axes:
        fns.append(functools.partial(mirror, axes=mirror_axes))
    fns.append(remove_label)
    return _chain(*fns)


def get_train_transforms_nomirror():
    return get_train_transforms(mirror_axes=())


def get_train_transforms_onlymirror():
    return _chain(mirror, remove_label)


def get_train_transforms_onlyspatial():
    return _chain(spatial_transform, remove_label)


def get_train_transforms_noaug():
    return _chain(remove_label)


def get_validation_transforms():
    return _chain(remove_label)
