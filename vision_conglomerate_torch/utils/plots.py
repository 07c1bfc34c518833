"""Metric-history plots drawn with PIL: one panel per metric, value against
epoch, stacked in one JPEG. The port needs no plotting library (the GPU
machines it targets have none)."""
from typing import Dict, Sequence

import numpy as np
from PIL import Image, ImageDraw

PANEL_W, PANEL_H, MARGIN = 900, 260, 60


def save_metric_plots(history: Dict[str, Sequence[float]], path: str, title: str):
    """history: metric name -> values per epoch. NaN points are skipped."""
    names = list(history)
    img = Image.new("RGB", (PANEL_W, PANEL_H * len(names)), "white")
    draw = ImageDraw.Draw(img)
    for i, name in enumerate(names):
        top = i * PANEL_H
        x0, y0, x1, y1 = MARGIN, top + 30, PANEL_W - 20, top + PANEL_H - 40
        draw.rectangle((x0, y0, x1, y1), outline="black")
        label = name.replace("_", " ").title()
        draw.text((x0, top + 8), f"[{title}] {label} vs Epoch", fill="black")
        v = np.asarray(history[name], dtype=np.float64)
        ok = np.isfinite(v)
        if not ok.any():
            continue
        lo, hi = float(v[ok].min()), float(v[ok].max())
        span = hi - lo or 1.0
        xs = x0 + (x1 - x0) * np.arange(len(v)) / max(len(v) - 1, 1)
        ys = y1 - (y1 - y0) * (v - lo) / span
        pts = [(float(x), float(y)) for x, y, k in zip(xs, ys, ok) if k]
        if len(pts) > 1:
            draw.line(pts, fill="blue", width=2)
        for x, y in pts:
            draw.ellipse((x - 2, y - 2, x + 2, y + 2), fill="blue")
        draw.text((4, y0), f"{hi:.4g}", fill="black")
        draw.text((4, y1 - 10), f"{lo:.4g}", fill="black")
        draw.text((x0, y1 + 8), f"epoch 0 .. {len(v) - 1}", fill="black")
    img.save(path, quality=90)
