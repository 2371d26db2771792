"""On-device training augmentation chain, PyTorch.

Port of ``segmamba_tpu/data/augment_device.py``: the default chain of
``data/augment.py`` (spatial warp, noise, blur, brightness, contrast, low
resolution, inverted and plain gamma, mirror, RemoveLabel(-1 -> 0)), run
on the batch's device inside the train step, so that the loader's
processes only crop patches. Same transforms, probabilities and ranges as
the JAX chain, transform for transform, with its documented deltas from
the host chain: the warp and the low-resolution upsampling interpolate
with Catmull-Rom cubic (trilinear for the seg), and blur edges are
nearest-clamped instead of scipy's reflect.

Layout: image (B, C, Z, Y, X) float32, label (B, Z, Y, X) integer with -1
marking crop padding (the JAX chain: (B, Z, Y, X, C)).

The draws are split from the arithmetic. ``draw_params`` draws a batch's
per-sample parameters (every coin, angle, scale, sigma, zoom, gamma and
mirror coin) from an explicit CPU ``torch.Generator``, so that no step
waits on the card, and the noise field on the batch's device from a
generator there, seeded from the host one. ``device_augment`` applies
given parameters. A transform whose coin did not fire is skipped (JAX
computes it and discards it with ``jnp.where``: the same result).

The warp is JAX's production warp, nine LU shear / scale passes
(``_lu_shear_passes``), each a batched float32 GEMM of (I_out x I_in)
interpolation matrices, with TF32 off as JAX's ``Precision.HIGHEST``. The
one-shot resampling (``_affine_coords`` with ``_trilinear`` /
``_tricubic``) is JAX's oracle for it and is kept for the tests.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, fields

import numpy as np
import torch
import torch.nn.functional as F

ANGLE = math.radians(30.0)


def _to(t, device):
    """``t`` on ``device``; to a card through pinned memory, without
    waiting for the card's queue."""
    if t.device == device:
        return t
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@contextlib.contextmanager
def _full_f32():
    """float32 matmuls at full precision (no TF32) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@dataclass
class AugmentParams:
    """One batch's draws, per sample (leading dim B). Host (CPU) tensors,
    except ``noise_field``, which lies on the batch's device (or is None
    when no noise coin fired)."""

    rot: torch.Tensor             # (B,) bool, rotation coin (p .2)
    scale_fire: torch.Tensor      # (B,) bool, scaling coin (p .2)
    angles: torch.Tensor          # (B, 3) U(-30 deg, 30 deg), axes z, y, x
    scale: torch.Tensor           # (B,) U(.7, 1.4)
    noise: torch.Tensor           # (B,) bool (p .1)
    noise_var: torch.Tensor       # (B,) U(0, .1)
    blur: torch.Tensor            # (B,) bool (p .2)
    blur_channel: torch.Tensor    # (B, C) bool (p .5)
    blur_sigma: torch.Tensor      # (B, C) U(.5, 1)
    brightness: torch.Tensor      # (B,) bool (p .15)
    brightness_mult: torch.Tensor  # (B, C) U(.75, 1.25)
    contrast: torch.Tensor        # (B,) bool (p .15)
    contrast_factor: torch.Tensor  # (B, C) U(.75, 1.25)
    lowres: torch.Tensor          # (B,) bool (p .25)
    lowres_channel: torch.Tensor  # (B, C) bool (p .5)
    lowres_zoom: torch.Tensor     # (B, C) U(.5, 1)
    gamma_inv: torch.Tensor       # (B,) bool (p .1), inverted gamma
    gamma_inv_g: torch.Tensor     # (B, C) its gamma
    gamma: torch.Tensor           # (B,) bool (p .3)
    gamma_g: torch.Tensor         # (B, C) its gamma
    mirror: torch.Tensor          # (B, 3) bool (p .5 per axis)
    noise_field: torch.Tensor | None = None   # (B, C, Z, Y, X) N(0, 1)

    def select(self, idx):
        """The parameters of samples ``idx`` (a list of ints)."""
        return AugmentParams(**{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name)[idx]) for f in fields(self)})


def _u(generator, lo, hi, shape):
    return lo + (hi - lo) * torch.rand(shape, generator=generator)


def _gamma_draw(generator, B, C, g_lo=0.7, g_hi=1.5):
    """Both candidate gammas are drawn; a coin per channel picks one."""
    coin = torch.rand((B, C), generator=generator) < 0.5
    low = _u(generator, g_lo, 1.0, (B, C))
    high = _u(generator, max(g_lo, 1.0), g_hi, (B, C))
    return torch.where(coin & (g_lo < 1.0), low, high)


def draw_params(shape, generator, device="cpu"):
    """Draw the chain's parameters for a batch of ``shape`` (B, C, Z, Y, X).

    Every scalar comes from ``generator`` (a CPU ``torch.Generator``), in a
    fixed order whatever fires. The noise field is drawn on ``device`` from
    a generator there, seeded by one draw of ``generator``, and only when a
    noise coin fired."""
    B, C = shape[:2]
    g = generator

    def coin(p, n=(B,)):
        return torch.rand(n, generator=g) < p

    p = dict(
        rot=coin(0.2), scale_fire=coin(0.2),
        angles=_u(g, -ANGLE, ANGLE, (B, 3)), scale=_u(g, 0.7, 1.4, (B,)),
        noise=coin(0.1), noise_var=_u(g, 0.0, 0.1, (B,)),
        blur=coin(0.2), blur_channel=coin(0.5, (B, C)),
        blur_sigma=_u(g, 0.5, 1.0, (B, C)),
        brightness=coin(0.15), brightness_mult=_u(g, 0.75, 1.25, (B, C)),
        contrast=coin(0.15), contrast_factor=_u(g, 0.75, 1.25, (B, C)),
        lowres=coin(0.25), lowres_channel=coin(0.5, (B, C)),
        lowres_zoom=_u(g, 0.5, 1.0, (B, C)),
        gamma_inv=coin(0.1), gamma_inv_g=_gamma_draw(g, B, C),
        gamma=coin(0.3), gamma_g=_gamma_draw(g, B, C),
        mirror=coin(0.5, (B, 3)))
    noise_seed = int(torch.randint(0, 2 ** 62, (1,), generator=g))
    if bool(p["noise"].any()):
        device = torch.device(device)
        dev_gen = torch.Generator(device=device).manual_seed(noise_seed)
        p["noise_field"] = torch.randn(tuple(shape), generator=dev_gen,
                                       device=device)
    return AugmentParams(**p)


def augment_generator(seed, step):
    """The CPU generator of one train step's draws, seeded by (``seed``,
    ``step``): a resumed run draws what an uninterrupted one would."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(2)
    return torch.Generator().manual_seed(
        int(state[0]) << 32 | int(state[1]))


# ---------------------------------------------------------------------------
# spatial warp (SpatialTransform: rot +-30 deg p=.2, scale .7-1.4 p=.2)
# ---------------------------------------------------------------------------


def _rotation_matrix(angles):
    """R2 @ R1 @ R0 from per-axis angles (B, 3) -> (B, 3, 3), the
    composition order of the host chain."""
    B = angles.shape[0]
    mat = torch.eye(3).expand(B, 3, 3)
    for ax in range(3):
        a = angles[:, ax]
        c, s = torch.cos(a), torch.sin(a)
        i, j = [k for k in range(3) if k != ax]
        rot = torch.eye(3).repeat(B, 1, 1)
        rot[:, i, i], rot[:, i, j] = c, -s
        rot[:, j, i], rot[:, j, j] = s, c
        mat = rot @ mat
    return mat


def _affine_coords(mat, shape):
    """Source coordinates (3, Z, Y, X) for the output grid under ``mat``
    about the volume center (src = mat @ (dst - center) + center)."""
    grid = torch.stack(torch.meshgrid(
        *[torch.arange(n, dtype=torch.float32, device=mat.device)
          for n in shape], indexing="ij"))
    center = (torch.tensor(shape, dtype=torch.float32, device=mat.device)
              - 1.0) / 2.0
    flat = grid.reshape(3, -1) - center[:, None]
    src = mat @ flat + center[:, None]
    return src.reshape(3, *shape)


def _gather_nd(vol, idx_z, idx_y, idx_x):
    Z, Y, X = vol.shape
    lin = (idx_z * Y + idx_y) * X + idx_x
    return vol.reshape(-1)[lin.reshape(-1)].reshape(idx_z.shape)


def _trilinear(vol, coords, cval):
    """Order-1 sampling of ``vol`` (Z, Y, X) with constant fill."""
    Z, Y, X = vol.shape
    cz, cy, cx = coords
    z0, y0, x0 = (torch.floor(c).long() for c in (cz, cy, cx))
    fz, fy, fx = cz - z0, cy - y0, cx - x0
    out = torch.zeros(cz.shape, dtype=vol.dtype, device=vol.device)
    for dz in (0, 1):
        wz = fz if dz else 1.0 - fz
        for dy in (0, 1):
            wy = fy if dy else 1.0 - fy
            for dx in (0, 1):
                wx = fx if dx else 1.0 - fx
                iz, iy, ix = z0 + dz, y0 + dy, x0 + dx
                valid = ((iz >= 0) & (iz < Z) & (iy >= 0) & (iy < Y)
                         & (ix >= 0) & (ix < X))
                v = _gather_nd(vol, iz.clamp(0, Z - 1), iy.clamp(0, Y - 1),
                               ix.clamp(0, X - 1))
                out = out + wz * wy * wx * torch.where(valid, v, cval)
    return out


def _catmull_rom_w(t):
    """4 weights for taps at offsets (-1, 0, 1, 2), t in [0, 1)."""
    t2, t3 = t * t, t * t * t
    return (
        -0.5 * t3 + t2 - 0.5 * t,
        1.5 * t3 - 2.5 * t2 + 1.0,
        -1.5 * t3 + 2.0 * t2 + 0.5 * t,
        0.5 * t3 - 0.5 * t2,
    )


def _tricubic(vol, coords, cval):
    """Catmull-Rom cubic sampling (64 taps) of ``vol`` (Z, Y, X) with
    constant fill."""
    Z, Y, X = vol.shape
    cz, cy, cx = coords
    z0, y0, x0 = (torch.floor(c).long() for c in (cz, cy, cx))
    wz = _catmull_rom_w(cz - z0)
    wy = _catmull_rom_w(cy - y0)
    wx = _catmull_rom_w(cx - x0)
    out = torch.zeros(cz.shape, dtype=torch.float32, device=vol.device)
    for dz in range(4):
        iz = z0 + dz - 1
        vz = (iz >= 0) & (iz < Z)
        izc = iz.clamp(0, Z - 1)
        for dy in range(4):
            iy = y0 + dy - 1
            vy = (iy >= 0) & (iy < Y)
            iyc = iy.clamp(0, Y - 1)
            w2 = wz[dz] * wy[dy]
            for dx in range(4):
                ix = x0 + dx - 1
                valid = vz & vy & (ix >= 0) & (ix < X)
                v = _gather_nd(vol, izc, iyc, ix.clamp(0, X - 1))
                out = out + w2 * wx[dx] * torch.where(valid, v, cval)
    return out


def _lu_shear_passes(mat):
    """Factor ``mat`` (B, 3, 3) into 9 elementary passes, in the order they
    are applied.

    Each pass is ``(axis_i, axis_j, m, alpha)`` with (B,) tensors: resample
    along ``axis_i`` at ``src_i = m*(v_i - c_i) + alpha*(v_j - c_j) + c_i``
    (``axis_j`` and ``alpha`` None for pure scales). Doolittle LU:
    mat = L(l10, l20, l21) @ diag(d) @ U'(u01, u02, u12). Each step does
    out_k(v) = out_{k-1}(P_k v), so the composed sampling matrix is
    P1 @ P2 @ ... @ P9 with P1 applied first: the list is in matrix-product
    order."""
    a = mat
    d0 = a[:, 0, 0]
    u01 = a[:, 0, 1] / d0
    u02 = a[:, 0, 2] / d0
    l10 = a[:, 1, 0] / d0
    l20 = a[:, 2, 0] / d0
    d1 = a[:, 1, 1] - l10 * u01 * d0
    u12 = (a[:, 1, 2] - l10 * u02 * d0) / d1
    l21 = (a[:, 2, 1] - l20 * u01 * d0) / d1
    d2 = a[:, 2, 2] - l20 * u02 * d0 - l21 * u12 * d1
    one = torch.ones_like(d0)
    # (I+aE01)(I+bE02)(I+cE12) == I + aE01 + (b+ac)E02 + cE12
    b_ = u02 - u01 * u12
    return [
        (1, 0, one, l10),     # E10
        (2, 0, one, l20),     # E20
        (2, 1, one, l21),     # E21
        (0, None, d0, None),  # S0
        (1, None, d1, None),  # S1
        (2, None, d2, None),  # S2
        (0, 1, one, u01),     # E01
        (0, 2, one, b_),      # E02
        (1, 2, one, u12),     # E12
    ]


def _pass_matrix(pos, size, order):
    """(.., I_out) sample positions -> (.., I_out, I_in) interpolation matrix
    plus the in-bounds weight mass (for constant fill). All taps go in one
    scatter: an out-of-bounds tap adds 0 to a clamped column, so each
    entry is its one weight whatever the order of the adds."""
    base = torch.floor(pos)
    t = pos - base
    base = base.long()
    if order == 3:
        ws, first = _catmull_rom_w(t), -1
    else:
        ws, first = (1.0 - t, t), 0
    idx = base[..., None] + (torch.arange(len(ws), device=pos.device)
                             + first)                      # (.., I_out, taps)
    wv = torch.where((idx >= 0) & (idx < size), torch.stack(ws, -1), 0.0)
    W = pos.new_zeros((*pos.shape, size)).scatter_add_(
        -1, idx.clamp_(0, size - 1), wv)
    return W, wv.sum(-1)


# volume (n, c, z, y, x); the pass along axis_i whose position depends on
# axis_j has one (I x I) matrix per index of axis_j
_PASS_SUBS = {
    (0, 1): "nyab,ncbyx->ncayx", (0, 2): "nxab,ncbyx->ncayx",
    (1, 0): "nzab,nczbx->nczax", (1, 2): "nxab,nczbx->nczax",
    (2, 0): "nzab,nczyb->nczya", (2, 1): "nyab,nczyb->nczya",
    (0, None): "nab,ncbyx->ncayx", (1, None): "nab,nczbx->nczax",
    (2, None): "nab,nczyb->nczya",
}


def _shear_pass(vol, axis_i, axis_j, m, alpha, order, cval):
    """One elementary resample of ``vol`` (n, C, Z, Y, X) along ``axis_i``;
    ``m``, ``alpha``: (n,) on ``vol``'s device."""
    n = vol.shape[0]
    shape = vol.shape[2:]
    I = shape[axis_i]
    ci = (I - 1) / 2.0
    ar = torch.arange(I, dtype=torch.float32, device=vol.device)
    pos = m[:, None] * (ar - ci) + ci                          # (n, I)
    if axis_j is not None:
        J = shape[axis_j]
        cj = (J - 1) / 2.0
        aj = torch.arange(J, dtype=torch.float32, device=vol.device)
        pos = pos[:, None, :] + alpha[:, None, None] * (aj - cj)[:, None]
    W, mass = _pass_matrix(pos, I, order)                     # (n, [J,] I, I)
    out = torch.einsum(_PASS_SUBS[(axis_i, axis_j)], W, vol)
    if cval != 0.0:
        miss = 1.0 - mass                               # (n, J, I) | (n, I)
        bshape = [n, 1, 1, 1, 1]
        bshape[2 + axis_i] = I
        if axis_j is not None:
            bshape[2 + axis_j] = J
            if axis_j > axis_i:
                miss = miss.transpose(1, 2)             # index as (i, j)
        out = out + cval * miss.reshape(bshape)
    return out


def _warp_affine_shear(vol, mat, order, cval):
    """Resample ``vol`` (n, C, Z, Y, X) at src = mat @ (dst - c) + c, one
    ``mat`` (n, 3, 3) a sample, by the shear passes. Centering conjugates
    every pass, so the composed map is exactly the centered affine."""
    out = vol.float()
    passes = _lu_shear_passes(mat)
    coef = _to(torch.stack([
        torch.stack([m, torch.zeros_like(m) if a is None else a])
        for _, _, m, a in passes]).float(), vol.device)       # (9, 2, n)
    with _full_f32():
        for k, (axis_i, axis_j, _, _) in enumerate(passes):
            out = _shear_pass(out, axis_i, axis_j, coef[k, 0],
                              None if axis_j is None else coef[k, 1],
                              order, cval)
    return out


# ---------------------------------------------------------------------------
# the chain's transforms; each takes the batch and its parameters and
# changes only the rows whose coins fired
# ---------------------------------------------------------------------------


def _rows(mask):
    """The indices of the True entries of a host bool tensor (flattened),
    or None when there is none."""
    idx = torch.nonzero(mask.reshape(-1)).flatten()
    return idx if len(idx) else None


def _take(x, idx):
    if len(idx) == x.shape[0]:
        return x
    return x.index_select(0, _to(idx, x.device))


def _put(x, idx, y):
    """Rows ``idx`` of ``x`` (our own tensor) set to ``y``."""
    if len(idx) == x.shape[0]:
        return y
    return x.index_copy_(0, _to(idx, x.device), y)


def _spatial(img, seg, params, order_data):
    idx = _rows(params.rot | params.scale_fire)
    if idx is None:
        return img, seg
    mat = torch.where(params.rot[:, None, None],
                      _rotation_matrix(params.angles), torch.eye(3))
    sc = torch.where(params.scale_fire, params.scale, 1.0)
    mat = (mat * sc[:, None, None])[idx]
    img_w = _warp_affine_shear(_take(img, idx), mat, order_data, 0.0)
    seg_w = torch.round(_warp_affine_shear(_take(seg, idx)[:, None], mat,
                                           1, -1.0)[:, 0])
    return _put(img, idx, img_w), _put(seg, idx, seg_w)


def _noise(img, params):
    idx = _rows(params.noise)
    if idx is None:
        return img
    std = _to(torch.sqrt(params.noise_var[idx]), img.device)
    n = _take(params.noise_field, idx) * std.view(-1, 1, 1, 1, 1)
    return _put(img, idx, _take(img, idx) + n)


def _blur_weights(sig, radius=4):
    """(P,) sigmas -> (P, 2 radius + 1) normalized gaussian taps; taps
    beyond int(4 sigma + 0.5) are zeroed before normalizing, as scipy's
    truncate=4 does."""
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32)
    w = torch.exp(-0.5 * (offs[None, :] / sig[:, None]) ** 2)
    eff = torch.floor(4.0 * sig + 0.5)
    w = torch.where(offs.abs()[None, :] <= eff[:, None], w, 0.0)
    return w / w.sum(dim=1, keepdim=True)


def _blur(img, params, radius=4):
    """Per-channel separable gaussian; edges nearest-clamped (scipy's
    gaussian_filter reflects; the difference is confined to a 4-voxel
    border of a stochastic transform)."""
    B, C = img.shape[:2]
    idx = _rows(params.blur[:, None] & params.blur_channel)
    if idx is None:
        return img
    w = _to(_blur_weights(params.blur_sigma.reshape(-1)[idx], radius),
            img.device)
    flat = img.reshape(B * C, *img.shape[2:])
    x = _take(flat, idx)[:, None]                       # (P, 1, Z, Y, X)
    for axis in range(3):
        pad = [0] * 6
        pad[4 - 2 * axis] = pad[5 - 2 * axis] = radius
        xp = F.pad(x, pad, mode="replicate")            # clamp to the edge
        n = x.shape[2 + axis]
        acc = torch.zeros_like(x)
        for i in range(2 * radius + 1):
            acc = acc + w[:, i].view(-1, 1, 1, 1, 1) * xp.narrow(
                2 + axis, i, n)
        x = acc
    return _put(flat, idx, x[:, 0]).reshape(img.shape)


def _brightness(img, params):
    idx = _rows(params.brightness)
    if idx is None:
        return img
    mult = _to(params.brightness_mult[idx], img.device)
    return _put(img, idx, _take(img, idx) * mult[..., None, None, None])


_SPATIAL = (2, 3, 4)


def _contrast(img, params):
    idx = _rows(params.contrast)
    if idx is None:
        return img
    f = _to(params.contrast_factor[idx], img.device)[..., None, None, None]
    x = _take(img, idx)
    mean = x.mean(dim=_SPATIAL, keepdim=True)
    mn = x.amin(dim=_SPATIAL, keepdim=True)
    mx = x.amax(dim=_SPATIAL, keepdim=True)
    return _put(img, idx, torch.clamp((x - mean) * f + mean, mn, mx))


def _axis_lowres_taps(n, z):
    """Index / weight taps along one axis of length ``n`` for the
    nearest-down + Catmull-Rom-up composite at zoom ``z`` (float32 tensor,
    a scalar or one zoom per row).

    down: small[i] = x[round(i (n-1) / (S-1))], S = round(n z);
    up:   out[j] = cubic(small, j (S-1) / (n-1)).
    Returns 4 index tensors and 4 weight tensors, each (*z.shape, n)."""
    S = torch.round(n * z)[..., None]
    j = torch.arange(n, dtype=torch.float32)
    pos = j * (S - 1.0) / (n - 1.0)
    base = torch.floor(pos)
    t = pos - base
    base = base.long()
    ws = _catmull_rom_w(t)
    top = torch.clamp(S - 1.0, min=0.0).long()
    den = torch.clamp(S - 1.0, min=1.0)
    idx = []
    for d in range(4):
        i_small = torch.minimum(torch.clamp(base + d - 1, min=0), top)
        i_full = torch.round(i_small * (n - 1.0) / den).long()
        idx.append(i_full.clamp(0, n - 1))
    return idx, ws


def _lowres_matrix(n, zs):
    """The (P, n, n) linear maps of ``_axis_lowres_taps`` for zooms ``zs``
    (P,): row j holds the weights of the input indices that out[j]
    reads (two taps that clamp to one index add up)."""
    idx, ws = _axis_lowres_taps(n, zs)
    return torch.zeros(len(zs), n, n).scatter_add_(
        -1, torch.stack(idx, -1), torch.stack(ws, -1))


_LOWRES_SUBS = ("pab,pbyx->payx", "pab,pzbx->pzax", "pab,pzyb->pzya")


def _lowres(img, params):
    B, C = img.shape[:2]
    idx = _rows(params.lowres[:, None] & params.lowres_channel)
    if idx is None:
        return img
    zs = params.lowres_zoom.reshape(-1)[idx]
    flat = img.reshape(B * C, *img.shape[2:])
    x = _take(flat, idx)                                # (P, Z, Y, X)
    mats = [_to(_lowres_matrix(n, zs), img.device) for n in x.shape[1:]]
    with _full_f32():
        for axis in range(3):
            x = torch.einsum(_LOWRES_SUBS[axis], mats[axis], x)
    return _put(flat, idx, x).reshape(img.shape)


def _gamma(img, fire, g, invert=False, retain_stats=True, eps=1e-7):
    idx = _rows(fire)
    if idx is None:
        return img
    g = _to(g[idx], img.device)[..., None, None, None]
    x = _take(img, idx)
    if invert:
        x = -x
    mean = x.mean(dim=_SPATIAL, keepdim=True)
    std = x.std(dim=_SPATIAL, correction=0, keepdim=True)
    mn = x.amin(dim=_SPATIAL, keepdim=True)
    rngv = torch.clamp(x.amax(dim=_SPATIAL, keepdim=True) - mn, min=eps)
    y = torch.pow((x - mn) / rngv, g) * rngv + mn
    if retain_stats:
        y = ((y - y.mean(dim=_SPATIAL, keepdim=True))
             / torch.clamp(y.std(dim=_SPATIAL, correction=0, keepdim=True),
                           min=1e-8) * std + mean)
    if invert:
        y = -y
    return _put(img, idx, y)


def _mirror(img, seg, coins, axes=(0, 1, 2)):
    for b in range(img.shape[0]):
        dims = [ax for ax in axes if coins[b, ax]]
        if dims:
            img[b] = torch.flip(img[b], [1 + ax for ax in dims])
            seg[b] = torch.flip(seg[b], dims)
    return img, seg


# ---------------------------------------------------------------------------
# chain
# ---------------------------------------------------------------------------


@torch.no_grad()
def device_augment(image, label, params, mirror_axes=(0, 1, 2),
                   order_data=3):
    """The default augmentation chain on ``image``'s device.

    Args:
      image:  (B, C, Z, Y, X) float tensor.
      label:  (B, Z, Y, X) integer labels; -1 marks crop padding.
      params: ``AugmentParams`` of this batch (``draw_params``).
    Returns (image float32, label int64) with the chain applied; the
    inputs are not changed."""
    img = image.to(torch.float32, copy=True)
    seg = label.to(torch.float32, copy=True)
    img, seg = _spatial(img, seg, params, order_data)
    img = _noise(img, params)
    img = _blur(img, params)
    img = _brightness(img, params)
    img = _contrast(img, params)
    img = _lowres(img, params)
    img = _gamma(img, params.gamma_inv, params.gamma_inv_g, invert=True)
    img = _gamma(img, params.gamma, params.gamma_g)
    if mirror_axes:
        img, seg = _mirror(img, seg, params.mirror, mirror_axes)
    lab = torch.round(seg).long()
    return img, torch.where(lab == -1, 0, lab)         # RemoveLabel(-1 -> 0)
