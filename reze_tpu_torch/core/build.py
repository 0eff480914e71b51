"""Host-side texture builders (counterpart of the mip and quad builders in
``reze_tpu/core/build.py``). Pure numpy; the outputs are moved to the
device with the rest of the model."""

from __future__ import annotations

import numpy as np


def build_mip_chain(
    texels: np.ndarray, sizes: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Dense mip pyramid for every texture, level 0 included.

    Level l+1 is the 2x2 box average of level l (odd trailing row/column
    dropped), down to 1x1; every texture carries the same global level
    count. Returns (mip_flat (S, 4) u8, mip_base (N, L) i32): level l of
    texture i spans ``mip_flat[mip_base[i, l] : + h_l * w_l]`` row-major.
    """
    n = texels.shape[0]
    hw = [(int(sizes[i, 0]), int(sizes[i, 1])) for i in range(n)]
    n_levels = max(1, max(max(h, w) for h, w in hw).bit_length())
    chunks: list[np.ndarray] = []
    base = np.zeros((n, n_levels), np.int64)
    off = 0
    for i in range(n):
        h, w = hw[i]
        img = texels[i, :h, :w].astype(np.float32)
        for lvl in range(n_levels):
            base[i, lvl] = off
            chunks.append(np.clip(np.rint(img), 0, 255).astype(np.uint8).reshape(-1, 4))
            off += img.shape[0] * img.shape[1]
            if img.shape[0] > 1:
                img = img[: img.shape[0] // 2 * 2]
                img = 0.5 * (img[0::2] + img[1::2])
            if img.shape[1] > 1:
                img = img[:, : img.shape[1] // 2 * 2]
                img = 0.5 * (img[:, 0::2] + img[:, 1::2])
    return np.concatenate(chunks, axis=0), base.astype(np.int32)


def _quad_pack_img(img: np.ndarray) -> np.ndarray:
    """(h, w, 4) u8 -> (h, w, 16): each texel's 2x2 footprint [self,
    right, down, right+down], edge-clamped."""
    h, w = img.shape[:2]
    xr = np.minimum(np.arange(w) + 1, w - 1)
    yd = np.minimum(np.arange(h) + 1, h - 1)
    r = img[:, xr]
    d = img[yd]
    return np.concatenate([img, r, d, d[:, xr]], axis=-1)


def build_quad_chain(
    mip_flat: np.ndarray, mip_base: np.ndarray, sizes: np.ndarray
) -> np.ndarray:
    """(S, 4) u8 mip chain -> (S, 16) u8 quad footprints."""
    n, n_levels = mip_base.shape
    quad = np.empty((mip_flat.shape[0], 16), np.uint8)
    for i in range(n):
        h, w = int(sizes[i, 0]), int(sizes[i, 1])
        for lvl in range(n_levels):
            hl, wl = max(h >> lvl, 1), max(w >> lvl, 1)
            b = int(mip_base[i, lvl])
            img = mip_flat[b:b + hl * wl].reshape(hl, wl, 4)
            quad[b:b + hl * wl] = _quad_pack_img(img).reshape(-1, 16)
    return quad


def build_quad_flat(texels: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Quad footprints of the padded level-0 atlas (stride = max width);
    texels outside a texture's real size pack as self-copies."""
    n, mh, mw, _ = texels.shape
    quad = np.concatenate([texels] * 4, axis=-1)
    for i in range(n):
        h, w = int(sizes[i, 0]), int(sizes[i, 1])
        quad[i, :h, :w] = _quad_pack_img(texels[i, :h, :w])
    return quad.reshape(-1, 16)
