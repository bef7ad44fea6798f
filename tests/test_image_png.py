"""PNG codec of the main path (yolotpu.image): zlib + numpy, no imaging
library. Decodes every shipped example like PIL does, round-trips, and
keeps cli/detect working (detections printed, PNG written) with PIL
absent."""

import glob
import io
import os
import sys

import numpy as np
import pytest

from yolotpu import image as yi

EXAMPLES = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "examples", "*.png")))


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_decode_examples_like_pil(path):
    got = yi.load_rgb(path)
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3
    Image = pytest.importorskip("PIL.Image")
    np.testing.assert_array_equal(got,
                                  np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "I;16"])
def test_decode_pil_encoded_modes(mode):
    """PIL-written PNGs of every color type (and 16-bit gray) decode to
    PIL's own RGB view; PIL's adaptive filters exercise all five."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (23, 37, 3), dtype=np.uint8)
    x[5:15] = x[5]                                 # runs favour Up/Sub
    im = Image.fromarray(x)
    if mode == "I;16":
        im = Image.fromarray(x[:, :, 0].astype(np.uint16) * 257)
        want = np.repeat(x[:, :, :1], 3, axis=2)
    else:
        im = im.convert(mode)
        want = np.asarray(im.convert("RGB"))
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    np.testing.assert_array_equal(yi.decode_png(buf.getvalue()), want)


@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 5, 3), (64, 48, 3),
                                   (9, 13)])
def test_png_round_trip(shape, tmp_path):
    x = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    back = yi.decode_png(yi.encode_png(x))
    want = x if x.ndim == 3 else np.repeat(x[:, :, None], 3, axis=2)
    np.testing.assert_array_equal(back, want)
    # and through the file API, CHW float in [0, 1]
    if x.ndim == 3:
        p = str(tmp_path / "rt.png")
        yi.save_image(x.transpose(2, 0, 1).astype(np.float32) / 255.0, p)
        np.testing.assert_array_equal(
            np.round(yi.load_image(p) * 255).astype(np.uint8),
            x.transpose(2, 0, 1))


def test_non_png_without_pil_says_so(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    p = tmp_path / "x.jpg"
    p.write_bytes(b"\xff\xd8\xff\xe0 not really a jpeg")
    with pytest.raises(RuntimeError, match="only PNG"):
        yi.load_image(str(p))


def test_detect_cli_without_pil(tmp_path, monkeypatch, capsys):
    """With PIL unimportable, cli/detect still prints its detections and
    writes the annotated PNG (labels left out, noted on stderr)."""
    from yolotpu.cli import detect
    from yolotpu.runtime import drawing
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setattr(drawing, "_warned_no_pil", False)
    monkeypatch.setenv("YOLO2_NO_DUMP", "1")
    out = str(tmp_path / "pred")
    rc = detect.main([EXAMPLES[0], "--net-size", "32", "--synthetic-weights",
                      "--thresh", "0.0", "--output", out])
    assert rc == 0
    captured = capsys.readouterr()
    assert "predicted in" in captured.out
    assert "%" in captured.out                      # thresh 0: labels print
    assert "labels are left out" in captured.err
    img = yi.load_rgb(out + ".png")
    assert img.shape == yi.load_rgb(EXAMPLES[0]).shape
