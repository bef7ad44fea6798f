"""Detection drawing: boxes + class labels onto images.

Equivalent of ``draw_detections`` (``src/core/yolo_post.cpp:248-307``) and the
board-side ``yolo2_draw.c``: per-class deterministic colors from darknet's
6-color wheel (``yolo_post.cpp:87-97``), box thickness scaled by image size,
text labels composited from the glyph alphabet (``runtime/alphabet.py``).
Boxes are drawn in numpy; labels need PIL's bitmap font and are left out,
with a note on stderr, where PIL is not installed.
"""

from __future__ import annotations

import sys

import numpy as np

_COLORS = np.array([[1, 0, 1], [0, 0, 1], [0, 1, 1],
                    [0, 1, 0], [1, 1, 0], [1, 0, 0]], np.float32)


def get_color(c: int, x: int, max_val: int) -> float:
    """darknet get_color: interpolate along the 6-color wheel."""
    ratio = (x / max_val) * 5
    i, j = int(np.floor(ratio)), int(np.ceil(ratio))
    ratio -= i
    return float((1 - ratio) * _COLORS[i][c] + ratio * _COLORS[j][c])


def class_rgb(cls: int, classes: int) -> tuple[int, int, int]:
    offset = cls * 123457 % classes if classes else 0
    return tuple(int(255 * get_color(c, offset, max(classes, 1)))
                 for c in (2, 1, 0))  # darknet draws (red,green,blue)=(2,1,0)


def _draw_rect(img: np.ndarray, left: int, top: int, right: int, bot: int,
               color: tuple[int, int, int], width: int) -> None:
    """Outline [left, right] x [top, bot] (inclusive) with ``width`` px lines
    drawn inward, on an HWC uint8 image in place."""
    c = np.asarray(color, np.uint8)
    for k in range(width):
        t, b, l, r = top + k, bot - k, left + k, right - k
        if t > b or l > r:
            break
        img[t, l:r + 1] = c
        img[b, l:r + 1] = c
        img[t:b + 1, l] = c
        img[t:b + 1, r] = c


_warned_no_pil = False


def _have_pil() -> bool:
    global _warned_no_pil
    try:
        import PIL  # noqa: F401
        return True
    except ImportError:
        if not _warned_no_pil:
            print("note: PIL is not installed; detection labels are left "
                  "out of drawn images (boxes are drawn)", file=sys.stderr)
            _warned_no_pil = True
        return False


def draw_detections(chw: np.ndarray, dets, names: list[str],
                    thresh: float, use_alphabet: bool = True) -> np.ndarray:
    """Draw boxes for every class with prob > thresh (like draw_detections);
    input/output CHW float [0,1].

    Labels composite from the synthesized glyph alphabet by default
    (``yolo_post.cpp:248-307`` get_label/draw_label flow, tier picked by
    image height h*0.03 like the reference); ``use_alphabet=False`` falls
    back to PIL text rendering."""
    h, w = chw.shape[1], chw.shape[2]
    img = np.clip(chw.transpose(1, 2, 0) * 255 + 0.5, 0, 255).astype(np.uint8)
    width = max(1, int(h * 0.006))
    labels = []
    for d in dets:
        cls = -1
        label = []
        for j in range(d.classes):
            if d.prob[j] > thresh:
                if cls < 0:
                    cls = j
                label.append(names[j] if j < len(names) else str(j))
        if cls < 0:
            continue
        bx, by, bw, bh = d.bbox
        left = int((bx - bw / 2) * w)
        right = int((bx + bw / 2) * w)
        top = int((by - bh / 2) * h)
        bot = int((by + bh / 2) * h)
        left, right = max(0, left), min(w - 1, right)
        top, bot = max(0, top), min(h - 1, bot)
        color = class_rgb(cls, d.classes)
        _draw_rect(img, left, top, right, bot, color, width)
        labels.append((top, left, ", ".join(label), color))
    if labels and not use_alphabet and _have_pil():
        from PIL import Image, ImageDraw
        pim = Image.fromarray(img)
        drw = ImageDraw.Draw(pim)
        for top, left, text, color in labels:
            drw.text((left + width + 1, max(0, top - 12)), text, fill=color)
        img = np.asarray(pim, np.uint8)
    out = img.astype(np.float32).transpose(2, 0, 1) / 255.0
    if labels and use_alphabet and _have_pil():
        from . import alphabet as alpha
        ab = alpha.load_alphabet()
        for top, left, text, color in labels:
            strip = alpha.get_label(ab, text, int(h * 0.03))
            alpha.draw_label(out, top + width, left, strip,
                             tuple(c / 255.0 for c in color))
    return out
