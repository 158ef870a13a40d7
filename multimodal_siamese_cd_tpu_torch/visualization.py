"""Visualization helpers: numpy image composition + PNG output (the port's
own copy of the JAX package's ``visualization.py``; same panels, same
bytes).

The reference's utils/visualization.py is broken (imports a deleted
``utils.paths`` module and undefined names — SURVEY defect 4) and everything
downstream draws with matplotlib, which this package does not use. This module
rebuilds the *intent* as pure-numpy image construction:

  * band selection / rescale for optical + SAR display
    (visualization.py:8-35 semantics),
  * TP/FP/FN classification coloring with the reference's palette
    (qualitative_comparison.py:143-146),
  * grid composition of panels into one RGB figure written via :mod:`.png`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import png

# TP white, FP green, FN purple on black (qualitative_comparison.py:144)
CLASSIFICATION_COLORS = np.array([
    [0, 0, 0],
    [255, 255, 255],
    [int(142 / 255 * 255), 255, 0],
    [int(140 / 255 * 255), 25, 140],
], np.uint8)


def to_uint8(img: np.ndarray, vmin: float = 0.0, vmax: float = 1.0) -> np.ndarray:
    x = (np.asarray(img, np.float32) - vmin) / max(vmax - vmin, 1e-12)
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def optical_rgb(img_hwc: np.ndarray, band_indices=(2, 1, 0),
                rescale_factor: float = 0.4) -> np.ndarray:
    """True-color composite from an optical stack (reference
    visualization.py:8-21: bands / rescale, clip to [0, 1])."""
    bands = np.asarray(img_hwc)[:, :, list(band_indices)] / rescale_factor
    return to_uint8(np.clip(bands, 0, 1))


def sar_gray(img_hwc: np.ndarray, band_index: int = 0) -> np.ndarray:
    """Single-band SAR display (reference visualization.py:24-35)."""
    band = np.clip(np.asarray(img_hwc)[:, :, band_index], 0, 1)
    return np.repeat(to_uint8(band)[:, :, None], 3, axis=2)


def gray_rgb(img: np.ndarray, vmin: float = 0.0, vmax: float = 1.0) -> np.ndarray:
    g = to_uint8(np.asarray(img).squeeze(), vmin, vmax)
    return np.repeat(g[:, :, None], 3, axis=2)


def split_modalities(x_hwc: np.ndarray, cfg) -> tuple:
    """``(s1, s2)`` channel blocks of an item image per
    ``DATALOADER.INPUT_MODE`` — the display-side twin of
    ``dataset._split_imgs``' layout. Items carry ONLY the configured
    modalities, so a fixed ``[:, :, n_s1:]`` slice is wrong for the
    shipped ``'s2'`` configs (it would drop real bands and crash
    :func:`optical_rgb`). A missing modality is ``None``."""
    mode = cfg.DATALOADER.INPUT_MODE
    if mode == 's1':
        return x_hwc, None
    if mode == 's2':
        return None, x_hwc
    n_s1 = len(cfg.DATALOADER.S1_BANDS)
    return x_hwc[:, :, :n_s1], x_hwc[:, :, n_s1:]


def imagery_panel(x_hwc: np.ndarray, cfg) -> np.ndarray:
    """Best-available display panel for an item image: true-color S2 when
    the config carries >=3 optical bands, else first-band grayscale (SAR
    for 's1' configs, single-band optical otherwise)."""
    s1, s2 = split_modalities(x_hwc, cfg)
    if s2 is not None and s2.shape[2] >= 3:
        return optical_rgb(s2)
    return sar_gray(s2 if s2 is not None else s1)


def get_misclassifications(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """0 TN / 1 TP / 2 FP / 3 FN map (reference qualitative_comparison.py:13-22)."""
    pred = np.asarray(pred).astype(bool)
    gt = np.asarray(gt).astype(bool)
    classification = np.zeros(pred.shape, np.uint8)
    classification[np.logical_and(pred, gt)] = 1
    classification[np.logical_and(pred, ~gt)] = 2
    classification[np.logical_and(~pred, gt)] = 3
    return classification


def classification_rgb(classification: np.ndarray) -> np.ndarray:
    return CLASSIFICATION_COLORS[np.asarray(classification, np.intp)]


def compose_grid(rows: list[list[np.ndarray]], pad: int = 4,
                 background: int = 255,
                 col_titles: list | None = None,
                 row_labels: list | None = None,
                 title: str | None = None) -> np.ndarray:
    """Stack panels (RGB uint8, possibly differing sizes) into one image.

    ``col_titles`` / ``row_labels`` / ``title`` render annotation strips
    with the embedded bitmap font — the PNG equivalent of the reference's
    matplotlib titles/axis labels (qualitative_comparison.py:96-141)."""
    from . import bitmap_font

    cell_h = max(p.shape[0] for row in rows for p in row)
    cell_w = max(p.shape[1] for row in rows for p in row)
    n_rows = len(rows)
    n_cols = max(len(r) for r in rows)

    scale = max(1, min(3, cell_w // 100))
    text_h = bitmap_font.GLYPH_H * scale
    top = pad + (text_h + pad if title else 0) + \
        (text_h + pad if col_titles else 0)
    left = pad
    if row_labels:
        left += max(bitmap_font.text_width(t, scale) for t in row_labels) + pad

    out = np.full((top + n_rows * (cell_h + pad),
                   left + n_cols * (cell_w + pad), 3), background, np.uint8)
    if title:
        bitmap_font.draw_text(out, title, pad, left, scale)
    if col_titles:
        y = pad + (text_h + pad if title else 0)
        for j, t in enumerate(col_titles[:n_cols]):
            x = left + j * (cell_w + pad)
            x += max((cell_w - bitmap_font.text_width(t, scale)) // 2, 0)
            bitmap_font.draw_text(out, t, y, x, scale)
    if row_labels:
        for i, t in enumerate(row_labels[:n_rows]):
            y = top + i * (cell_h + pad) + (cell_h - text_h) // 2
            bitmap_font.draw_text(out, t, y, pad, scale)

    for i, row in enumerate(rows):
        for j, panel in enumerate(row):
            if panel.ndim == 2:
                panel = np.repeat(panel[:, :, None], 3, axis=2)
            y = top + i * (cell_h + pad)
            x = left + j * (cell_w + pad)
            out[y:y + panel.shape[0], x:x + panel.shape[1]] = panel
    return out


def save_figure(path: str | Path, rows: list[list[np.ndarray]], pad: int = 4,
                col_titles: list | None = None, row_labels: list | None = None,
                title: str | None = None) -> Path:
    return png.write_png(path, compose_grid(
        rows, pad=pad, col_titles=col_titles, row_labels=row_labels,
        title=title))
