"""Write the committed JPEG fixtures and their expected decodes.

    python tests/torch_fixtures/jpeg/make_fixtures.py

Each fixture is smooth gradients plus a little noise, from a seeded numpy
generator, saved by Pillow; the set covers what the port's decoder must
read as Pillow and libjpeg do (4:2:0, 4:4:4, 4:2:2, grayscale, progressive,
restart intervals, sizes that are not multiples of the MCU, DCT scaling at
1/2 and 1/4 in the 256-pixel cache view, CMYK).  The ``exotic_*`` files
take what Pillow's encoder does not write (4:1:1, 4:4:0, 2x1 chroma under
a 2x2 luma, YCCK, Adobe RGB, grayscale at 2x2 sampling): they are written
by ``libjpeg_encoder.cpp``, which this script builds with ``g++ -ljpeg``.  ``expected.json`` holds,
per file, the sha256 and the byte sum of three uint8 arrays computed here
from the JAX package's own means:

- ``full``: Pillow's ``Image.open(path).convert("RGB")``;
- ``raw256``: ``fsvlm_tpu.native.decode_file(path, 256)`` (null where it
  has no RGB output: CMYK), and ``cache256``: the JAX package's
  ``RawDatasetWrapper`` view at 256 (the PIL branch for CMYK);
- ``eval224``: the JAX eval view before normalizing (bicubic resize of the
  shorter edge to 224, centre crop).

``tests/test_torch_decode.py`` and ``chip_smoke.py`` (phase 12) hold the
port's decodes of these files to these digests.
"""

import hashlib
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

# name: (width, height, Pillow mode, save options)
FIXTURES = {
    "imagenet_500x375_420.jpg": (500, 375, "RGB", dict(quality=90, subsampling=2)),
    "caltech_300x200_420.jpg": (300, 200, "RGB", dict(quality=75, subsampling=2)),
    "yuv444_320x240.jpg": (320, 240, "RGB", dict(quality=85, subsampling=0)),
    "yuv422_333x257.jpg": (333, 257, "RGB", dict(quality=85, subsampling=1)),
    "gray_280x210.jpg": (280, 210, "L", dict(quality=85)),
    "progressive_400x300.jpg": (400, 300, "RGB", dict(quality=85, subsampling=2,
                                                      progressive=True)),
    "restart_360x270.jpg": (360, 270, "RGB", dict(quality=85, subsampling=2,
                                                  restart_marker_blocks=3)),
    "odd_201x137_prog_rst.jpg": (201, 137, "RGB", dict(quality=95, subsampling=2,
                                                       progressive=True,
                                                       restart_marker_rows=1)),
    "scale2_640x512.jpg": (640, 512, "RGB", dict(quality=80, subsampling=2)),
    "scale4_1280x1024.jpg": (1280, 1024, "RGB", dict(quality=75, subsampling=2)),
    "cmyk_300x225.jpg": (300, 225, "CMYK", dict(quality=85)),
}
# name: (width, height, components, sampling per component, quality,
# progressive, restart rows, colour space: 0 default, 1 RGB / YCCK)
EXOTIC = {
    "exotic_411_181x97.jpg": (181, 97, 3, "41,11,11", 85, 0, 0, 0),
    "exotic_440_prog_150x121.jpg": (150, 121, 3, "12,11,11", 85, 1, 0, 0),
    "exotic_22_21_11_rst_133x90.jpg": (133, 90, 3, "22,21,11", 90, 0, 1, 0),
    "exotic_ycck_120x80.jpg": (120, 80, 4, "22,11,11,22", 85, 0, 0, 1),
    "exotic_adobe_rgb_97x61.jpg": (97, 61, 3, "11,11,11", 90, 0, 0, 1),
    "exotic_gray22_101x77.jpg": (101, 77, 1, "22", 85, 1, 0, 0),
}
SEED = 12
PRE_SIZE = 256
EVAL_SIZE = (224, 224)


def content(rng, h, w, channels):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    planes = []
    for k in range(channels):
        a, b = rng.uniform(0.004, 0.03, 2)
        planes.append(127 + 90 * np.sin(a * xx + b * yy + 2 * k) * np.cos(b * xx - a * yy))
    img = np.stack(planes, -1) + rng.normal(0, 4, (h, w, channels))
    return np.clip(img, 0, 255).astype(np.uint8)


def digest(a):
    a = np.ascontiguousarray(a, np.uint8)
    return {"shape": list(a.shape), "sha256": hashlib.sha256(a.tobytes()).hexdigest(),
            "sum": int(a.sum(dtype=np.int64))}


def _encoder():
    """Build libjpeg_encoder.cpp (needs libjpeg's header and library)."""
    import subprocess
    import tempfile

    exe = os.path.join(tempfile.mkdtemp(), "libjpeg_encoder")
    subprocess.run(["g++", "-O2", "-o", exe, os.path.join(HERE, "libjpeg_encoder.cpp"), "-ljpeg"],
                   check=True)
    return exe


def main():
    from fsvlm_tpu import native
    from fsvlm_tpu.data import transforms as jax_transforms
    from fsvlm_tpu.data.base_dataset import Datum
    from fsvlm_tpu.data.loader import RawDatasetWrapper

    if not native.native_available():
        raise SystemExit("fsvlm_tpu.native is not built (make -C native)")
    import subprocess

    rng = np.random.RandomState(SEED)
    exe = _encoder()
    expected = {}
    for name in [*FIXTURES, *EXOTIC]:
        path = os.path.join(HERE, name)
        if name in FIXTURES:
            w, h, mode, opts = FIXTURES[name]
            arr = content(rng, h, w, {"L": 1, "RGB": 3, "CMYK": 4}[mode])
            Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(path, "JPEG", **opts)
        else:
            w, h, nc, *args = EXOTIC[name]
            subprocess.run([exe, path, str(w), str(h), str(nc), *map(str, args)], check=True,
                           input=content(rng, h, w, nc).tobytes())
        full = Image.open(path).convert("RGB")
        raw = native.decode_file(path, PRE_SIZE)
        cache = RawDatasetWrapper([Datum(impath=path)], pre_size=PRE_SIZE)[0]["img"]
        view = jax_transforms._resize_center_crop(full, EVAL_SIZE,
                                                  jax_transforms._PIL_INTERP["bicubic"])
        expected[name] = {"full": digest(np.asarray(full)),
                          "raw256": None if raw is None else digest(raw),
                          "cache256": digest(cache), "eval224": digest(np.asarray(view))}
    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(HERE, n)) for n in os.listdir(HERE))
    print(f"wrote {len(FIXTURES) + len(EXOTIC)} fixtures and expected.json: {total} bytes in {HERE}")


if __name__ == "__main__":
    main()
