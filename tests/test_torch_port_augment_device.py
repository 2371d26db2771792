"""The port's on-device augmentation chain against the JAX package's, on
the CPU.

``segmamba_tpu_torch.data.augment_device`` (channel-first, parameters drawn
apart from the arithmetic) against ``segmamba_tpu.data.augment_device``
(channels-last, JAX keys):

- The building blocks on the same arrays, at rtol 1e-5 / atol 1e-5 x
  max|x|: the LU shear factorization, the interpolation matrices, every
  (axis_i, axis_j) kind of shear pass on a non-cubic volume with fill 0
  and -1 (a cube would hide swapped axes), the whole shear warp at orders
  1 and 3, the low-resolution taps, the rotation matrix and the one-shot
  oracle (``_affine_coords``, ``_trilinear``, ``_tricubic``).
- The whole chain: ``params_from_key`` turns a ``jax.random.key`` into the
  port's per-sample parameters by the JAX chain's own key splitting
  (``device_augment``, ``_augment_sample`` and the splits inside each
  transform) and passes JAX's noise field. JAX's ``device_augment`` and the
  port's chain then run on one batch (B = 4, two channels, 12 x 16 x 20,
  labels in {-1 .. 2}) for several keys, and on a key with every coin
  forced to fire (JAX's transforms called with p = 1, as
  ``_augment_sample`` calls them). Images at rtol 1e-4 / atol 1e-4 x
  max|x|; labels equal on every voxel except where JAX's value before
  rounding lies within 1e-4 of a half-integer (the test reports them).
- The port's own draws: fire rates over 4,000 samples within 4 sigma of
  each p, the same generator gives the same output, a sample where only
  the mirror fired is an exact flip, labels >= 0 after RemoveLabel.

CPU time: about 20 s, most of it two JAX compiles of the chain.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segmamba_tpu.data import augment_device as J
from segmamba_tpu_torch.data import augment_device as T

DEFAULT = dict(rot=.2, scale=.2, noise=.1, blur=.2, blur_ch=.5, bright=.15,
               contrast=.15, lowres=.25, lowres_ch=.5, gamma_inv=.1,
               gamma=.3, mirror=.5)
ALL = {k: 1.0 for k in DEFAULT}
SHAPE = (4, 2, 12, 16, 20)          # B, C, Z, Y, X


def _u(key, lo=0.0, hi=1.0, shape=()):
    return np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, hi))


def params_from_key(key, shape, probs=DEFAULT):
    """The port's parameters for JAX's draws from ``key`` (the chain's key
    splitting, transform for transform), with JAX's noise field."""
    B, C, Z, Y, X = shape
    out = {f.name: [] for f in dataclasses.fields(T.AugmentParams)}
    angle = math.radians(30.0)
    for kb in jax.random.split(key, B):
        ks = jax.random.split(kb, 9)
        kd, kr, ksc, _ = jax.random.split(ks[0], 4)
        out["rot"].append(_u(kd) < probs["rot"])
        out["scale_fire"].append(_u(jax.random.fold_in(kd, 1))
                                 < probs["scale"])
        out["angles"].append(np.stack([_u(k, -angle, angle)
                                       for k in jax.random.split(kr, 3)]))
        out["scale"].append(_u(ksc, 0.7, 1.4))
        k1, k2, k3 = jax.random.split(ks[1], 3)
        out["noise"].append(_u(k1) < probs["noise"])
        out["noise_var"].append(_u(k2, 0.0, 0.1))
        out["noise_field"].append(np.moveaxis(np.asarray(
            jax.random.normal(k3, (Z, Y, X, C), jnp.float32)), -1, 0))
        k1, k2, k3 = jax.random.split(ks[2], 3)
        out["blur"].append(_u(k1) < probs["blur"])
        out["blur_channel"].append(_u(k2, 0, 1, (C,)) < probs["blur_ch"])
        out["blur_sigma"].append(_u(k3, 0.5, 1.0, (C,)))
        for name, kk, p, factor in (
                ("brightness", ks[3], probs["bright"], "brightness_mult"),
                ("contrast", ks[4], probs["contrast"], "contrast_factor")):
            k1, k2 = jax.random.split(kk)
            out[name].append(_u(k1) < p)
            out[factor].append(_u(k2, 0.75, 1.25, (C,)))
        k1, k2, k3 = jax.random.split(ks[5], 3)
        out["lowres"].append(_u(k1) < probs["lowres"])
        out["lowres_channel"].append(_u(k2, 0, 1, (C,)) < probs["lowres_ch"])
        out["lowres_zoom"].append(_u(k3, 0.5, 1.0, (C,)))
        for name, kk in (("gamma_inv", ks[6]), ("gamma", ks[7])):
            k1, k2, k3 = jax.random.split(kk, 3)
            out[name].append(_u(k1) < probs[name])
            coin = _u(k2, 0, 1, (C,)) < 0.5
            out[name + "_g"].append(np.where(
                coin, _u(k3, 0.7, 1.0, (C,)),
                _u(jax.random.fold_in(k3, 1), 1.0, 1.5, (C,))))
        out["mirror"].append(_u(ks[8], 0, 1, (3,)) < probs["mirror"])
    return T.AugmentParams(**{k: torch.from_numpy(np.stack(v))
                              for k, v in out.items()})


@jax.jit
def _jax_all_firing(img, seg, key):
    """JAX's chain with every coin forced: ``_augment_sample`` with p = 1
    for each transform (and each channel); mirror flips all three axes."""
    def one(i, s, k):
        ks = jax.random.split(k, 9)
        segf = s.astype(jnp.float32)
        i, segf = J._spatial(i, segf, ks[0], 1.0, 1.0, math.radians(30.0),
                             0.7, 1.4, 3)
        i = J._noise(i, ks[1], p=1.0)
        i = J._blur(i, ks[2], p=1.0, p_channel=1.0)
        i = J._brightness(i, ks[3], p=1.0)
        i = J._contrast(i, ks[4], p=1.0)
        i = J._lowres(i, ks[5], p=1.0, p_channel=1.0)
        i = J._gamma(i, ks[6], p=1.0, invert=True)
        i = J._gamma(i, ks[7], p=1.0, invert=False)
        i, segf = jnp.flip(i, (0, 1, 2)), jnp.flip(segf, (0, 1, 2))
        sg = jnp.rint(segf).astype(jnp.int32)
        return i, jnp.where(sg == -1, 0, sg)
    return jax.vmap(one)(img, seg, jax.random.split(key, img.shape[0]))


def _close(got, want, rtol=1e-5, atol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30))


def _mats(n, seed):
    """n warp matrices of the chain's range (rotation x scale)."""
    rng = np.random.default_rng(seed)
    angles = torch.from_numpy(rng.uniform(-0.52, 0.52, (n, 3))
                              .astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.7, 1.4, n).astype(np.float32))
    return T._rotation_matrix(angles) * scale[:, None, None]


# -- building blocks -----------------------------------------------------------


def test_rotation_matrix_matches_jax():
    key = jax.random.key(11)
    p = params_from_key(key, (1, 1, 2, 2, 2), ALL)
    kr = jax.random.split(jax.random.split(jax.random.split(key, 1)[0],
                                           9)[0], 4)[1]
    _close(T._rotation_matrix(p.angles)[0],
           J._rotation_matrix(kr, math.radians(30.0)))


def test_lu_shear_passes_match_jax():
    mats = _mats(6, 0)
    passes = T._lu_shear_passes(mats)
    for b in range(6):
        want = J._lu_shear_passes(jnp.asarray(mats[b].numpy()))
        assert [(i, j) for i, j, _, _ in passes] == [(i, j) for i, j, _, _
                                                     in want]
        for (_, j, m, a), (_, _, wm, wa) in zip(passes, want):
            _close(m[b], wm)
            if j is not None:
                _close(a[b], wa)


def test_shear_warp_effective_matrix():
    """Warping coordinate ramps of a non-cubic volume recovers src = mat @
    (dst - c) + c (order 1 is exact on degree-1 fields, and composing the
    passes in their order keeps it): the pass order and every axis."""
    shape = (15, 17, 19)
    mat = torch.tensor([[0.9, 0.2, -0.1], [0.1, 1.1, 0.15],
                        [-0.05, 0.1, 0.95]])
    c = (np.asarray(shape, np.float64) - 1) / 2.0
    ramps = torch.stack(torch.meshgrid(
        *[torch.arange(n, dtype=torch.float32) for n in shape],
        indexing="ij"))[None]                          # (1, 3, Z, Y, X)
    out = T._warp_affine_shear(ramps, mat[None], 1, 0.0)[0].numpy()
    for p in [(7, 8, 9), (5, 9, 11), (9, 7, 6)]:
        want = mat.double().numpy() @ (np.asarray(p) - c) + c
        np.testing.assert_allclose(out[(slice(None), *p)], want, atol=1e-4)


@pytest.mark.parametrize("order", [1, 3])
def test_pass_matrix_matches_jax(order):
    pos = np.random.default_rng(order).uniform(-3.0, 14.0, (5, 11)).astype(
        np.float32)
    W, mass = T._pass_matrix(torch.from_numpy(pos), 11, order)
    jW, jmass = J._pass_matrix(jnp.asarray(pos), 11, order)
    _close(W, jW)
    _close(mass, jmass)


KINDS = [(i, j) for i in range(3) for j in (None, *range(3)) if j != i]


@pytest.mark.parametrize("cval", [0.0, -1.0])
@pytest.mark.parametrize("kind", KINDS, ids=str)
def test_shear_pass_matches_jax(kind, cval):
    """Every elementary pass on a non-cubic volume (12, 16, 20) x 2
    channels; with fill -1 the missing mass lands on the right axes."""
    axis_i, axis_j = kind
    rng = np.random.default_rng(7)
    vol = rng.standard_normal((12, 16, 20, 2)).astype(np.float32)
    m, alpha = np.float32(0.87), np.float32(0.31)
    for order in (1, 3):
        got = T._shear_pass(
            torch.from_numpy(np.moveaxis(vol, -1, 0))[None], axis_i, axis_j,
            torch.tensor([m]), None if axis_j is None else torch.tensor(
                [alpha]), order, cval)[0]
        want = J._shear_pass(jnp.asarray(vol), axis_i, axis_j, m,
                             None if axis_j is None else alpha, order, cval)
        _close(got, np.moveaxis(np.asarray(want), -1, 0))


@pytest.mark.parametrize("order,cval", [(1, -1.0), (3, 0.0)])
def test_warp_affine_shear_matches_jax(order, cval):
    rng = np.random.default_rng(order)
    vol = rng.standard_normal((2, 12, 16, 20, 3)).astype(np.float32)
    mats = _mats(2, order + 10)
    got = T._warp_affine_shear(torch.from_numpy(np.moveaxis(vol, -1, 1)),
                               mats, order, cval)
    for b in range(2):
        want = J._warp_affine_shear(jnp.asarray(vol[b]),
                                    jnp.asarray(mats[b].numpy()), order,
                                    cval)
        _close(got[b], np.moveaxis(np.asarray(want), -1, 0))


@pytest.mark.parametrize("n", [12, 17, 20])
def test_axis_lowres_taps_match_jax(n):
    for z in np.random.default_rng(n).uniform(0.5, 1.0, 6).astype(
            np.float32):
        idx, ws = T._axis_lowres_taps(n, torch.tensor(z))
        jidx, jws = J._axis_lowres_taps(n, jnp.asarray(z))
        for a, b in zip(idx, jidx):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(ws, jws):
            _close(a, b)


def test_oracle_matches_jax():
    rng = np.random.default_rng(3)
    vol = rng.standard_normal((10, 13, 15)).astype(np.float32)
    mat = _mats(1, 5)[0]
    coords = T._affine_coords(mat, vol.shape)
    jcoords = J._affine_coords(jnp.asarray(mat.numpy()), vol.shape)
    _close(coords, jcoords)
    for port, jax_fn in ((T._trilinear, J._trilinear),
                         (T._tricubic, J._tricubic)):
        _close(port(torch.from_numpy(vol), coords, -1.0),
               jax_fn(jnp.asarray(vol), jcoords, -1.0))


# -- the whole chain -----------------------------------------------------------


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal(SHAPE).astype(np.float32)
    seg = rng.integers(-1, 3, (SHAPE[0], *SHAPE[2:]))
    return img, seg


def _near_half(seg, params):
    """Voxels where JAX's warped seg, before rounding, lies within 1e-4 of
    a half-integer (after the sample's mirror flips)."""
    amb = np.zeros(seg.shape, bool)
    fire = (params.rot | params.scale_fire).numpy()
    mats = (torch.where(params.rot[:, None, None],
                        T._rotation_matrix(params.angles), torch.eye(3))
            * torch.where(params.scale_fire, params.scale, 1.0)[:, None,
                                                                 None])
    for b in np.flatnonzero(fire):
        v = np.asarray(J._warp_affine_shear(
            jnp.asarray(seg[b], jnp.float32)[..., None],
            jnp.asarray(mats[b].numpy()), 1, -1.0))[..., 0]
        a = np.abs(v - np.floor(v) - 0.5) < 1e-4
        flips = [ax for ax in range(3) if params.mirror[b, ax]]
        amb[b] = np.flip(a, flips) if flips else a
    return amb


@pytest.mark.parametrize("key", [0, 1, 2, "all"])
def test_chain_matches_jax(key):
    img, seg = _batch()
    jimg = jnp.asarray(np.moveaxis(img, 1, -1))
    jseg = jnp.asarray(seg.astype(np.int32))
    if key == "all":
        jkey = jax.random.key(3)
        want_img, want_seg = _jax_all_firing(jimg, jseg, jkey)
        params = params_from_key(jkey, SHAPE, ALL)
        assert all(bool(getattr(params, f).all()) for f in (
            "rot", "scale_fire", "noise", "blur", "blur_channel",
            "brightness", "contrast", "lowres", "lowres_channel",
            "gamma_inv", "gamma", "mirror"))
    else:
        jkey = jax.random.key(key)
        want_img, want_seg = J.device_augment(jimg, jseg, jkey)
        params = params_from_key(jkey, SHAPE)
    got_img, got_seg = T.device_augment(torch.from_numpy(img),
                                        torch.from_numpy(seg), params)
    want_img = np.moveaxis(np.asarray(want_img), -1, 1)
    _close(got_img, want_img, rtol=1e-4, atol=1e-4)
    amb = _near_half(seg, params)
    miss = (got_seg.numpy() != np.asarray(want_seg)) & ~amb
    print(f"key {key}: {int(amb.sum())} label voxels within 1e-4 of a "
          "half-integer before rounding (not compared)")
    assert not miss.any(), f"{int(miss.sum())} labels differ"
    assert got_seg.dtype == torch.int64 and int(got_seg.min()) >= 0


# -- the port's own draws ------------------------------------------------------


def test_fire_rates_and_ranges():
    n, C = 4000, 2
    p = T.draw_params((n, C, 1, 1, 1), torch.Generator().manual_seed(0))
    rates = {"rot": .2, "scale_fire": .2, "noise": .1, "blur": .2,
             "blur_channel": .5, "brightness": .15, "contrast": .15,
             "lowres": .25, "lowres_channel": .5, "gamma_inv": .1,
             "gamma": .3, "mirror": .5}
    for name, rate in rates.items():
        x = getattr(p, name).float()
        sigma = math.sqrt(rate * (1 - rate) / x.numel())
        assert abs(float(x.mean()) - rate) < 4 * sigma, name
    assert float(p.angles.abs().max()) <= math.radians(30.0)
    for name, lo, hi in (("scale", .7, 1.4), ("noise_var", 0, .1),
                         ("blur_sigma", .5, 1.), ("lowres_zoom", .5, 1.),
                         ("brightness_mult", .75, 1.25),
                         ("gamma_g", .7, 1.5), ("gamma_inv_g", .7, 1.5)):
        x = getattr(p, name)
        assert lo <= float(x.min()) and float(x.max()) <= hi, name
    assert p.noise_field.shape == (n, C, 1, 1, 1)


def test_same_generator_same_output():
    img, seg = (torch.from_numpy(a) for a in _batch(1))
    outs = []
    for _ in range(2):
        params = T.draw_params(img.shape, T.augment_generator(49, 12))
        outs.append(T.device_augment(img, seg, params))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    other = T.draw_params(img.shape, T.augment_generator(49, 13))
    assert not torch.equal(other.angles, params.angles)


def test_mirror_only_samples_are_exact_flips_and_labels_cleared():
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.standard_normal((128, 1, 6, 7, 8))
                           .astype(np.float32))
    seg = torch.from_numpy(rng.integers(-1, 3, (128, 6, 7, 8)))
    params = T.draw_params(img.shape, torch.Generator().manual_seed(5))
    out_img, out_seg = T.device_augment(img, seg, params)
    others = torch.zeros(128, dtype=torch.bool)
    for name in ("rot", "scale_fire", "noise", "blur", "brightness",
                 "contrast", "lowres", "gamma_inv", "gamma"):
        others |= getattr(params, name)
    only_mirror = np.flatnonzero(~others.numpy())
    assert len(only_mirror) >= 10
    for b in only_mirror:
        dims = [ax for ax in range(3) if params.mirror[b, ax]]
        want = torch.flip(img[b], [1 + d for d in dims]) if dims else img[b]
        assert torch.equal(out_img[b], want)
        want_seg = torch.flip(seg[b], dims) if dims else seg[b]
        assert torch.equal(out_seg[b], want_seg.clamp(min=0))
    assert int(out_seg.min()) >= 0


def test_inputs_unchanged():
    """The chain works on copies, also of float labels (which ``.to``
    would hand back as they are): here the warp fires for some samples
    (rows written in place) and the mirror for others."""
    img, seg = (torch.from_numpy(a) for a in _batch(2))
    seg = seg.float()
    params = params_from_key(jax.random.key(0), SHAPE)
    fire = params.rot | params.scale_fire
    assert 0 < int(fire.sum()) < SHAPE[0] and bool(params.mirror.any())
    keep_img, keep_seg = img.clone(), seg.clone()
    T.device_augment(img, seg, params)
    assert torch.equal(img, keep_img) and torch.equal(seg, keep_seg)
