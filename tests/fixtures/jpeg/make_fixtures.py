"""Writes the JPEG fixtures of this folder and MANIFEST.json.

    cc -O2 transcode.c -ljpeg -o /tmp/transcode
    python make_fixtures.py /tmp/transcode VIEW_PNG

VIEW_PNG is an 800x800 rendered view (``gstex_torch.scripts.render``
writes one); the small images are made here from a seed. Needs PIL,
cv2 and a libjpeg with arithmetic coding (``transcode.c``)."""

import hashlib
import io
import json
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))
from jpeg_streams import JFIF, lossless_jpeg  # noqa: E402


def photo(h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w].astype(np.float64)
    a = np.stack([128 + 100 * np.sin(x / 7 + y / 11),
                  128 + 90 * np.cos(x / 5 - y / 9),
                  128 + 60 * np.sin((x + y) / 13)], -1)
    return np.clip(a + rng.normal(0, 12, a.shape), 0, 255).astype(np.uint8)


def pil(img, mode=None, **kw):
    buf = io.BytesIO()
    im = Image.fromarray(img)
    (im.convert(mode) if mode else im).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def cv(img, *params):
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                           list(params))
    assert ok
    return buf.tobytes()


def main(transcode, view_png):
    tmp = HERE / "_tmp.jpg"

    def trans(src: bytes, *opts) -> bytes:
        tmp.write_bytes(src)
        out = HERE / "_out.jpg"
        subprocess.run([transcode, str(tmp), str(out), *opts], check=True)
        data = out.read_bytes()
        out.unlink()
        return data

    small = photo(45, 61, 1)
    view = np.asarray(Image.open(view_png).convert("RGB"))
    base = pil(small, quality=88)
    colour = photo(33, 47, 2)
    cmyk = np.asarray(Image.fromarray(colour).convert("CMYK"))
    raw = HERE / "_cmyk.raw"
    raw.write_bytes(cmyk.tobytes())
    subprocess.run([transcode, "--ycck", "47", "33", str(raw), str(tmp)],
                   check=True)
    ycck = tmp.read_bytes()
    raw.unlink()
    prog, seq = cv2.IMWRITE_JPEG_PROGRESSIVE, cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    fixtures = {
        "prog_pil.jpg": (pil(small, quality=88, progressive=True),
                         "PIL save(progressive=True), quality 88, 4:2:0"),
        "prog_grey_pil.jpg": (pil(small, "L", quality=90, progressive=True),
                              "PIL grey, progressive, quality 90"),
        "prog_cv2.jpg": (cv(small, cv2.IMWRITE_JPEG_QUALITY, 90, prog, 1),
                         "cv2.imencode progressive, quality 90"),
        "s440_cv2.jpg": (cv(small, seq, 0x121111),
                         "cv2.imencode 4:4:0 (sampling factor 0x121111)"),
        "s411_cv2.jpg": (cv(small, seq, 0x411111),
                         "cv2.imencode 4:1:1 (sampling factor 0x411111)"),
        "s411_prog_cv2.jpg": (cv(small, seq, 0x411111, prog, 1),
                              "cv2.imencode 4:1:1, progressive"),
        "cmyk_pil.jpg": (pil(colour, "CMYK", quality=90),
                         "PIL save of a CMYK image (Adobe, transform 0)"),
        "ycck.jpg": (ycck, "transcode --ycck: libjpeg CMYK -> YCCK, "
                           "quality 90"),
        "prog_rst.jpg": (trans(base, "prog", "rst=4"),
                         "transcode prog rst=4 of a PIL quality-88 frame"),
        "arith_seq.jpg": (trans(base, "arith"),
                          "transcode arith of a PIL quality-88 frame"),
        "arith_prog.jpg": (trans(base, "arith", "prog"),
                           "transcode arith prog"),
        "arith_rst.jpg": (trans(base, "arith", "rst=5"),
                          "transcode arith rst=5"),
        "arith_prog_rst.jpg": (trans(base, "arith", "prog", "rst=3"),
                               "transcode arith prog rst=3"),
        "arith_dac.jpg": (trans(base, "arith", "prog", "dac"),
                          "transcode arith prog dac (DC L=1 U=4, AC K=2)"),
        "arith_411.jpg": (trans(cv(small, seq, 0x411111), "arith"),
                          "transcode arith of the 4:1:1 frame"),
        "lossless_grey.jpg": (lossless_jpeg(small[..., 1], 5, 1, JFIF),
                              "tests/jpeg_streams.py lossless_jpeg, grey, "
                              "predictor 5, point transform 1"),
        "lossless_rgb.jpg": (lossless_jpeg(small, 7, 0),
                             "lossless_jpeg, 3 components (RGB: no JFIF "
                             "marker), predictor 7"),
        "prog_800.jpg": (pil(view, quality=90, progressive=True),
                         "an 800x800 rendered view, PIL progressive, "
                         "quality 90"),
        "arith_800.jpg": (trans(pil(view, quality=90), "arith"),
                          "the same view, PIL quality 90, transcode arith"),
    }
    tmp.unlink()
    manifest = {}
    for name, (data, how) in fixtures.items():
        (HERE / name).write_bytes(data)
        rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        manifest[name] = {
            "sha256": hashlib.sha256(data).hexdigest(),
            "rgb_sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
            "shape": list(rgb.shape), "made_by": how}
    (HERE / "MANIFEST.json").write_text(json.dumps(manifest, indent=1)
                                        + "\n")


if __name__ == "__main__":
    main(*sys.argv[1:])
