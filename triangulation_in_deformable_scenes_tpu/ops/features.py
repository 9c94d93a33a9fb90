"""Image front-end: FAST detection, orientation, ORB description -- batched.

Rebuilds the reference's extractor stack (``Modules/Features/FAST.cc``,
``ORB.cc``) as dense fixed-shape array ops:

- scale pyramid with linear resampling (``FAST::computePyramid``);
- FAST-9/16 corner SCORE map computed for every pixel at once (16 shifted
  images + contiguous-arc min/max) instead of per-cell ``cv::FAST`` calls;
  the two-threshold-per-cell fallback (``FAST.cc:186-193``) becomes a mask:
  a cell that has no high-threshold corner admits low-threshold ones;
- 3x3 non-max suppression + per-level top-k by score. The reference's
  quadtree distribution (``FAST.cc:243-436``) is replaced by NMS + top-k --
  a deliberate deviation (data-dependent tree subdivision does not map to
  fixed-shape compute); parity target is feature count/quality;
- specular-reflection + border masks, dilated per octave with the reference's
  kernel schedule (``FAST::GenerateMasks``, FAST.cc:474-527);
- intensity-centroid orientation over the r=15 circular patch
  (``FAST::IC_Angle``, FAST.cc:443-467);
- 256-pair rotated BRIEF descriptor (``ORB::computeORBDescriptor``) using the
  standard OpenCV ``bit_pattern_31_`` table (shipped as ``orb_pattern.npy``;
  numeric data, required for descriptor compatibility). The descriptor path
  is PATCH-LOCAL: one [43, 43] patch gather per keypoint feeds the
  orientation (center crop) and a valid-mode 7x7 sigma-2 blur (bit-exact
  with blurring the whole level, since every tap is interior), and the
  rotated taps select from the blurred patch via one-hot matmuls instead of
  8 full-image blurs and a scattered [N, 256] global gather. Descriptors
  are kept as [N, 256] 0/1 int8 so Hamming distance becomes one matmul
  (see ``ops/matching.py``).

All functions are jit-compatible with static shapes; keypoints are padded to
``max_keypoints`` with a validity mask.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from ..precision import FP, MATMUL_PRECISION

EDGE = 19  # reference EDGE_THRESHOLD
HALF_PATCH = 15
_PATTERN = np.load(os.path.join(os.path.dirname(__file__), "orb_pattern.npy"))  # [256, 4]

# FAST-9/16 Bresenham circle, clockwise from 12 o'clock: (dy, dx).
_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)
_ARC = 9  # contiguous arc length for FAST-9/16


def _umax_table(r=HALF_PATCH) -> np.ndarray:
    """Circular-patch row extents, as the reference builds in the FAST ctor."""
    umax = np.zeros(r + 1, dtype=np.int32)
    vmax = int(np.floor(r * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(r * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(r * r - v * v)))
    # ensure symmetry (ORB-SLAM's correction loop)
    v0 = 0
    for v in range(r, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


_UMAX = _umax_table()


def _circular_mask() -> np.ndarray:
    """[31, 31] inclusion mask of the orientation patch."""
    m = np.zeros((2 * HALF_PATCH + 1, 2 * HALF_PATCH + 1), dtype=np.float32)
    for v in range(-HALF_PATCH, HALF_PATCH + 1):
        d = _UMAX[abs(v)]
        m[v + HALF_PATCH, HALF_PATCH - d : HALF_PATCH + d + 1] = 1.0
    return m


_CMASK = _circular_mask()


def resize_linear(im, shape):
    return jax.image.resize(im, shape, method="linear")


def build_pyramid(im, n_scales: int, scale_factor: float):
    """Level-by-level linear downscaling (``FAST::computePyramid``).

    Returns a list of float arrays (level shapes are static at trace time).
    """
    levels = [im]
    h, w = im.shape
    for level in range(1, n_scales):
        inv = 1.0 / (scale_factor**level)
        sz = (int(round(h * inv)), int(round(w * inv)))
        levels.append(resize_linear(levels[-1], sz))
    return levels


def gaussian_blur(im, ksize=7, sigma=2.0):
    """Separable Gaussian (``ORB::computePyramid`` blurs 7x7 sigma=2)."""
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = jnp.asarray(k / k.sum(), dtype=im.dtype)
    pad = jnp.pad(im, ((r, r), (r, r)), mode="reflect")
    out = jax.vmap(lambda row: jnp.convolve(row, k, mode="valid"))(pad)
    out = jax.vmap(lambda col: jnp.convolve(col, k, mode="valid"), in_axes=1, out_axes=1)(out)
    return out


def fast_score(im):
    """FAST-9/16 corner score for every pixel: max over the 16 contiguous
    9-arcs of the minimal absolute center difference (OpenCV semantics: a
    pixel is a corner at threshold t iff score > t)."""
    shifted = jnp.stack(
        [jnp.roll(im, (-int(dy), -int(dx)), axis=(0, 1)) for dy, dx in _CIRCLE], axis=0
    )  # [16, H, W]
    d = shifted - im[None]
    # windows of 9 contiguous offsets (wraparound): index table [16, 9]
    idx = (np.arange(16)[:, None] + np.arange(_ARC)[None, :]) % 16
    d_arcs_bright = jnp.min(d[idx], axis=1)  # [16, H, W]
    d_arcs_dark = jnp.min(-d[idx], axis=1)
    score = jnp.maximum(jnp.max(d_arcs_bright, axis=0), jnp.max(d_arcs_dark, axis=0))
    # Invalidate a 3px frame (circle out of bounds via roll wraparound).
    h, w = im.shape
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    inb = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return jnp.where(inb, score, -jnp.inf)


def _cell_reduce_max(x, cell):
    h, w = x.shape
    ph = (-h) % cell
    pw = (-w) % cell
    xp = jnp.pad(x, ((0, ph), (0, pw)), constant_values=-jnp.inf)
    hb, wb = xp.shape[0] // cell, xp.shape[1] // cell
    m = xp.reshape(hb, cell, wb, cell).max(axis=(1, 3))
    up = jnp.repeat(jnp.repeat(m, cell, axis=0), cell, axis=1)
    return up[:h, :w]


def eligible_corners(score, th_high, th_low, cell=30):
    """Two-threshold-per-cell rule (FAST.cc:186-193) as a mask."""
    high = score > th_high
    cell_has_high = _cell_reduce_max(jnp.where(high, 1.0, 0.0), cell) > 0
    return high | ((~cell_has_high) & (score > th_low))


def nms3(score):
    pad = jnp.pad(score, 1, constant_values=-jnp.inf)
    neigh = jnp.stack(
        [
            pad[1 + dy : pad.shape[0] - 1 + dy, 1 + dx : pad.shape[1] - 1 + dx]
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if not (dy == 0 and dx == 0)
        ],
        axis=0,
    )
    return score >= jnp.max(neigh, axis=0)


def dilate_mask(mask, side):
    """Binary dilation with a side x side rect kernel.

    Log-doubling shift-max: a 1-D max filter of radius r decomposes into
    ceil(log2 r) elementwise maxima with power-of-two shifted copies (for
    max, over-covering is harmless), applied separably per axis. The
    reference's per-octave kernels grow as 2^octave (side 859 at octave 7 on
    full-res images): a windowed reduce is O(side) work per pixel, while
    this form is O(log side) full-image vector ops. Kernels larger than the image saturate and are
    clamped.
    """
    h, w = mask.shape
    side = int(min(side, 2 * max(h, w) + 1))
    r = side // 2
    x = mask.astype(jnp.float32)

    def shift0(x, s, axis):
        """roll with zeros shifted in (no wraparound)."""
        shifted = jnp.roll(x, s, axis=axis)
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(0, s) if s > 0 else slice(x.shape[axis] + s, None)
        return shifted.at[tuple(idx)].set(0.0)

    def dilate_axis(x, radius, axis):
        # Invariant: x covers the max over offsets [-m, m]. A +-s shifted max
        # extends coverage to [-(m+s), m+s] contiguously whenever s <= m+1;
        # doubling with s = m+1 reaches m = 2^k - 1, and one final shift by
        # the remainder lands on EXACTLY `radius`.
        m = 0
        while 2 * m + 1 <= radius:
            s = m + 1
            x = jnp.maximum(x, jnp.maximum(shift0(x, s, axis), shift0(x, -s, axis)))
            m = 2 * m + 1
        rem = radius - m
        if rem > 0:
            x = jnp.maximum(x, jnp.maximum(shift0(x, rem, axis), shift0(x, -rem, axis)))
        return x

    if r > 0:
        x = dilate_axis(x, r, 0)
        x = dilate_axis(x, r, 1)
    return x > 0


def generate_masks(im, border_mask, n_scales: int, color_threshold=240.0):
    """Exclusion masks per octave (``FAST::GenerateMasks``): border mask OR
    specular reflections (> 240), dilated with side = ceil(2^(i+1)*(2.5/1.5))*2+5."""
    base = im > color_threshold
    if border_mask is not None:
        base = base | (border_mask > 0)
    masks = []
    max_scale = 1
    for i in range(n_scales):
        max_scale *= 2
        side = int(np.ceil(max_scale * (2.5 / 1.5))) * 2 + 5
        masks.append(dilate_mask(base, side))
    return masks


def features_per_level(n_features: int, n_scales: int, scale_factor: float):
    """Geometric per-level budget (ORB-SLAM distribution used by the ref)."""
    f = 1.0 / scale_factor
    counts = [int(round(n_features * (1 - f) / (1 - f**n_scales) * (f**l))) for l in range(n_scales)]
    counts[-1] = max(n_features - sum(counts[:-1]), 0)
    return counts


class Keypoints(NamedTuple):
    xy: jnp.ndarray  # [M, 2] full-resolution (x, y)
    level_xy: jnp.ndarray  # [M, 2] coordinates in the level image
    octave: jnp.ndarray  # [M] int32
    score: jnp.ndarray  # [M]
    angle: jnp.ndarray  # [M] degrees
    desc: jnp.ndarray  # [M, 256] int8 0/1 bits
    valid: jnp.ndarray  # [M] bool


def topk_level(score, mask, k):
    """Top-k corner positions of one level; returns (xy [k, 2], score [k], ok [k])."""
    s = jnp.where(mask, score, -jnp.inf).reshape(-1)
    vals, flat = jax.lax.top_k(s, k)
    w = score.shape[1]
    xy = jnp.stack([flat % w, flat // w], axis=-1)
    return xy, vals, jnp.isfinite(vals)


def ic_angle(im, xy, valid):
    """Intensity-centroid angle (degrees) for integer keypoints xy [N, 2]."""
    patch = _extract_patches(im, xy, HALF_PATCH)
    return ic_angle_from_patches(patch, valid)


def ic_angle_from_patches(patch, valid):
    """IC angle from pre-gathered [N, 31, 31] patches (FAST::IC_Angle)."""
    u = jnp.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=patch.dtype)
    cm = jnp.asarray(_CMASK, dtype=patch.dtype)
    m10 = jnp.einsum("nvu,u,vu->n", patch, u, cm, precision=MATMUL_PRECISION)
    m01 = jnp.einsum("nvu,v,vu->n", patch, u, cm, precision=MATMUL_PRECISION)
    ang = jnp.degrees(jnp.arctan2(m01, m10))
    ang = jnp.where(ang < 0, ang + 360.0, ang)
    return jnp.where(valid, ang, 0.0)


def _extract_patches(im, xy, r):
    """Gather (2r+1)^2 patches around integer centers; image must carry a
    reflect pad of at least r (callers pad with EDGE=19 >= 15)."""
    def one(c):
        return jax.lax.dynamic_slice(im, (c[1] - r, c[0] - r), (2 * r + 1, 2 * r + 1))

    return jax.vmap(one)(xy)


def orb_descriptors(im_blur, xy, angle, valid):
    """Rotated-BRIEF bits [N, 256] (``ORB::computeORBDescriptor``)."""
    pat = jnp.asarray(_PATTERN, dtype=FP)  # [256, 4] (x0, y0, x1, y1)
    rad = jnp.radians(angle)
    a, b = jnp.cos(rad), jnp.sin(rad)

    def taps(px, py):
        # row offset = round(px*b + py*a), col offset = round(px*a - py*b)
        ry = jnp.round(px[None, :] * b[:, None] + py[None, :] * a[:, None]).astype(jnp.int32)
        rx = jnp.round(px[None, :] * a[:, None] - py[None, :] * b[:, None]).astype(jnp.int32)
        yy = xy[:, 1:2] + ry
        xx = xy[:, 0:1] + rx
        return im_blur[yy, xx]  # [N, 256]

    t0 = taps(pat[:, 0], pat[:, 1])
    t1 = taps(pat[:, 2], pat[:, 3])
    bits = (t0 < t1).astype(jnp.int8)
    return jnp.where(valid[:, None], bits, 0)


# Descriptor tap radius: the bit_pattern_31_ points live in a +-13 box but
# their DIAGONAL radius is 18.4, so rotated+rounded taps reach +-18
# (matching OpenCV, whose taps also leave the nominal 31x31 patch); the
# 7x7 blur needs 3 more. Keypoints sit >= 16px from the level edge
# (detection margin) and the level is EDGE=19-padded, so every tap stays
# interior to the padded image.
TAP_R = 18
DESC_R = TAP_R + 3  # 21


def blur_patches(patches):
    """VALID-mode separable 7x7 sigma-2 Gaussian over [N, 43, 43] patches.

    For patch centers >= EDGE from the padded-image border every output
    pixel equals the corresponding pixel of ``gaussian_blur`` applied to
    the full padded image (the full-image version's reflect pad only
    affects a 3px frame the patches never reach), so descriptor parity with
    the full-image-blur formulation is exact -- while the work drops from
    8 full pyramid levels to N x 37 x 37.
    """
    r = 3
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / 2.0) ** 2)
    k = jnp.asarray(k / k.sum(), dtype=patches.dtype)
    n, h, w = patches.shape
    rows = jax.lax.conv_general_dilated(
        patches[:, None], k.reshape(1, 1, 1, 2 * r + 1),
        window_strides=(1, 1), padding="VALID",
    )
    cols = jax.lax.conv_general_dilated(
        rows, k.reshape(1, 1, 2 * r + 1, 1),
        window_strides=(1, 1), padding="VALID",
    )
    return cols[:, 0]  # [N, 37, 37]


def tap_offsets(angle):
    """Rotated tap offsets of the 512 BRIEF endpoints (the 256 pairs' two
    ends), each ``[N, 512]`` int32 rows/cols relative to the keypoint:
    row = round(px*sin + py*cos), col = round(px*cos - py*sin)."""
    pat = jnp.asarray(_PATTERN, dtype=FP)  # [256, 4] (x0, y0, x1, y1)
    rad = jnp.radians(angle)
    a, b = jnp.cos(rad), jnp.sin(rad)
    px = jnp.concatenate([pat[:, 0], pat[:, 2]])
    py = jnp.concatenate([pat[:, 1], pat[:, 3]])
    ry = jnp.round(px[None, :] * b[:, None] + py[None, :] * a[:, None]).astype(jnp.int32)
    rx = jnp.round(px[None, :] * a[:, None] - py[None, :] * b[:, None]).astype(jnp.int32)
    return ry, rx


def orb_descriptors_from_patches(patches_blur, angle, valid):
    """Rotated-BRIEF bits from pre-gathered blurred [N, 37, 37] patches.

    Same bits as ``orb_descriptors`` (the taps are relative to the keypoint
    and bounded by +-TAP_R), but the lookup is IN-PATCH: the taps select
    from each keypoint's own patch instead of a scattered [N, 256] gather
    over the whole blurred level.

    The select is written as a one-hot row-select matmul plus a one-hot
    column dot. Each sum has exactly one nonzero term, so in full f32
    (``MATMUL_PRECISION``) the bits are identical to the plain gather
    ``orb_descriptors_gather``; a TF32 product would round the pixel
    operand and could flip bits.
    """
    side = 2 * TAP_R + 1
    dtype = patches_blur.dtype
    ry, rx = tap_offsets(angle)
    iot = jnp.arange(side, dtype=jnp.int32)
    oh_y = (ry[..., None] + TAP_R == iot).astype(dtype)  # [N, 512, 37]
    oh_x = (rx[..., None] + TAP_R == iot).astype(dtype)
    rows = jnp.einsum("nkv,nvu->nku", oh_y, patches_blur, precision=MATMUL_PRECISION)
    t = jnp.einsum("nku,nku->nk", oh_x, rows, precision=MATMUL_PRECISION)  # [N, 512]

    t0, t1 = t[:, :256], t[:, 256:]
    bits = (t0 < t1).astype(jnp.int8)
    return jnp.where(valid[:, None], bits, 0)


def orb_descriptors_gather(patches_blur, angle, valid):
    """Plain reference for ``orb_descriptors_from_patches``: the same taps
    read with ``take_along_axis`` over the flattened patch."""
    n, side, _ = patches_blur.shape
    ry, rx = tap_offsets(angle)
    flat_idx = (ry + TAP_R) * side + (rx + TAP_R)
    t = jnp.take_along_axis(patches_blur.reshape(n, side * side), flat_idx, axis=1)
    bits = (t[:, :256] < t[:, 256:]).astype(jnp.int8)
    return jnp.where(valid[:, None], bits, 0)


def descriptor_patches(im_level, xy, ok):
    """Blurred [N, 37, 37] descriptor patches and IC angles of integer
    keypoints ``xy`` on an unpadded level image.

    ONE [43, 43] patch gather per keypoint feeds both the orientation
    (center 31x31 of the raw patch) and the descriptor (valid-blurred to
    37x37, taps in-patch)."""
    impad = jnp.pad(im_level, EDGE, mode="reflect")
    P = _extract_patches(impad, xy + EDGE, DESC_R)  # [k, 43, 43]
    c = DESC_R - HALF_PATCH
    ang = ic_angle_from_patches(P[:, c:-c, c:-c], ok)
    return blur_patches(P), ang


def extract_level(
    im_level,
    mask_level,
    k: int,
    th_high: float,
    th_low: float,
    cell: int = 30,
):
    """Full per-level extraction: score -> cell thresholds -> NMS -> top-k ->
    orientation -> descriptors. ``im_level`` is unpadded; masks exclude
    reflective/border regions (mask=True means excluded)."""
    score = fast_score(im_level)
    elig = eligible_corners(score, th_high, th_low, cell)
    keep = elig & nms3(score) & (~mask_level)
    # Detection margin mirroring the reference's borders (EDGE-3 on the
    # padded image == 16px from the level edge).
    h, w = im_level.shape
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    margin = (yy >= 16) & (yy < h - 16) & (xx >= 16) & (xx < w - 16)
    keep = keep & margin

    xy, vals, ok = topk_level(score, keep, k)
    patches_blur, ang = descriptor_patches(im_level, xy, ok)
    desc = orb_descriptors_from_patches(patches_blur, ang, ok)
    return xy, vals, ok, ang, desc


def extract(
    im,
    n_features: int,
    n_scales: int,
    scale_factor: float,
    th_high: float = 20.0,
    th_low: float = 7.0,
    border_mask=None,
) -> Keypoints:
    """Multi-scale extraction over the pyramid; returns padded Keypoints.

    ``im`` is float [H, W] in 0..255. Total capacity = sum of per-level
    budgets (== n_features).

    The whole multi-level pipeline compiles as ONE jitted program per
    (image shape, config): every level shape is static at trace time, so the
    Python level loop unrolls into a single XLA computation instead of one
    dispatch per primitive per level.
    """
    im = jnp.asarray(im, dtype=jnp.float32)
    if border_mask is None:
        return _extract_jit(
            im, None, n_features, n_scales, float(scale_factor), float(th_high), float(th_low)
        )
    return _extract_jit(
        im,
        jnp.asarray(border_mask),
        n_features,
        n_scales,
        float(scale_factor),
        float(th_high),
        float(th_low),
    )


@functools.partial(
    jax.jit, static_argnames=("n_features", "n_scales", "scale_factor", "th_high", "th_low")
)
def _extract_jit(
    im, border_mask, n_features, n_scales, scale_factor, th_high, th_low
) -> Keypoints:
    pyramid = build_pyramid(im, n_scales, scale_factor)
    masks = generate_masks(im, border_mask, n_scales)
    budgets = features_per_level(n_features, n_scales, scale_factor)

    outs = []
    for level, (lvl_im, budget) in enumerate(zip(pyramid, budgets)):
        if budget <= 0:
            continue
        scale = scale_factor**level
        mask_l = resize_linear(masks[level].astype(jnp.float32), lvl_im.shape) > 0.5
        xy, vals, ok, ang, desc = extract_level(lvl_im, mask_l, budget, th_high, th_low)
        outs.append(
            Keypoints(
                xy=xy.astype(FP) * scale,
                level_xy=xy.astype(FP),
                octave=jnp.full((budget,), level, dtype=jnp.int32),
                score=vals,
                angle=ang,
                desc=desc,
                valid=ok,
            )
        )
    return Keypoints(*[jnp.concatenate([getattr(o, f) for o in outs], axis=0) for f in Keypoints._fields])
