"""Write the committed PNG fixtures and their expected decodes.

    python tests/torch_fixtures/png/make_fixtures.py

The files are written by ``encode_png`` below (zlib and struct, no Pillow),
so that every colour type, bit depth, filter and Adam7 can be reached;
``tests/test_torch_png.py`` writes its run-time cases with it too.  The
pixels come from a seeded numpy generator: line art on white at PACS's
sketch size (227 x 227) in the layouts a sketch or digit set holds (RGB 8,
gray 8, palette 4-bit with tRNS, RGBA 8, 16-bit RGB, 16-bit gray, 1-bit
gray, Adam7 RGB), a 32 x 32 RGB image (CIFAR), a 96 x 96 RGB image
(STL-10), a PNG under a ``.jpg`` name (as in ImageNet's train set), and a
truncated PNG (PACS lists one, ``sketch/dog/n02103406_4068-1.png``).
``expected.json`` holds, per readable file, the sha256 and the byte sum of
three uint8 arrays computed here from the JAX package's own means:

- ``full``: Pillow's ``Image.open(path).convert("RGB")``;
- ``cache256``: the JAX package's ``RawDatasetWrapper`` view at 256 (the
  PIL branch: Pillow's bilinear resize of the shorter edge, centre crop);
- ``eval224``: the JAX eval view before normalizing (bicubic resize of the
  shorter edge to 224, centre crop);

and ``truncated`` the names that must raise.  ``tests/test_torch_png.py``
and ``chip_smoke.py`` (phase 17) hold the port's decodes to these digests.
"""

import hashlib
import json
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
SEED = 17
PRE_SIZE = 256
EVAL_SIZE = (224, 224)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xffffffff))


def _pack_rows(samples, depth):
    """(h, w, c) samples to the rows' bytes: big-endian 16-bit, or bits
    packed MSB first below 8."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    n = flat.shape[1]
    padded = np.zeros((h, -(-n // per) * per), np.uint8)
    padded[:, :n] = flat
    shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
    return (padded.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def _filter_row(kind, row, prev, bpp):
    row = row.astype(np.int32)
    prev = np.zeros_like(row) if prev is None else prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])[:len(row)]
    c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])[:len(row)]
    if kind == 0:
        pred = np.zeros_like(row)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = prev
    elif kind == 3:
        pred = (a + prev) >> 1
    else:
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
    return ((row - pred) & 255).astype(np.uint8)


def _scanlines(samples, depth, channels, filters, row0=0):
    rows = _pack_rows(samples, depth)
    bpp = max(1, channels * depth // 8)
    out, prev = [], None
    for r, row in enumerate(rows):
        kind = filters[(row0 + r) % len(filters)]
        out.append(bytes([kind]) + _filter_row(kind, row, prev, bpp).tobytes())
        prev = row
    return b"".join(out)


def encode_png(samples, color, depth, *, interlace=False, filters=(0, 1, 2, 3, 4),
               palette=None, trns=None, level=6, strategy=zlib.Z_DEFAULT_STRATEGY,
               idat_sizes=None, empty_idat=False, ancillary=(), method=(0, 0, None),
               end=True):
    """A PNG file's bytes.  ``samples``: (h, w, channels) integers (palette
    indices for colour type 3); ``filters``: the filter types, cycled over
    the scanlines of each pass; ``idat_sizes``: cut the stream into IDAT
    chunks of these sizes (cycled); ``empty_idat``: an empty IDAT first and
    between the others; ``ancillary``: (type, body) chunks before IDAT;
    ``method``: IHDR's compression and filter methods and, if not None, its
    interlace byte as written; ``end``: write IEND."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, channels = samples.shape
    assert channels == CHANNELS[color]
    if interlace:
        parts = [_scanlines(samples[y0::dy, x0::dx], depth, channels, filters)
                 for x0, y0, dx, dy in ADAM7 if samples[y0::dy, x0::dx].size]
        raw = b"".join(parts)
    else:
        raw = _scanlines(samples, depth, channels, filters)
    comp = zlib.compressobj(level, zlib.DEFLATED, 15, 9, strategy)
    stream = comp.compress(raw) + comp.flush()
    ilace = int(interlace) if method[2] is None else method[2]
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, method[0], method[1],
                                       ilace))]
    out += [_chunk(k, b) for k, b in ancillary]
    if palette is not None:
        out.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        out.append(_chunk(b"tRNS", bytes(trns)))
    pieces, i, k = [], 0, 0
    sizes = idat_sizes or [len(stream) or 1]
    while i < len(stream):
        pieces.append(stream[i:i + sizes[k % len(sizes)]])
        i += sizes[k % len(sizes)]
        k += 1
    for piece in pieces:
        if empty_idat:
            out.append(_chunk(b"IDAT", b""))
        out.append(_chunk(b"IDAT", piece))
    if end:
        out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def line_art(rng, h, w, strokes=40):
    """Dark strokes on white: a random walk of short line segments."""
    img = np.full((h, w), 255, np.int32)
    y, x = rng.uniform(0, h), rng.uniform(0, w)
    for _ in range(strokes):
        ny, nx = np.clip(y + rng.normal(0, h / 6), 0, h - 1), np.clip(x + rng.normal(0, w / 6),
                                                                    0, w - 1)
        n = int(max(abs(ny - y), abs(nx - x))) + 1
        ys = np.linspace(y, ny, n).round().astype(int)
        xs = np.linspace(x, nx, n).round().astype(int)
        shade = int(rng.randint(0, 90))
        for dy in (0, 1):
            img[np.clip(ys + dy, 0, h - 1), xs] = shade
        y, x = ny, nx
    return img


def _files(rng):
    """name -> PNG bytes."""
    s = 227
    files = {}
    g = line_art(rng, s, s)
    tint = rng.randint(0, 40, 3)
    rgb = np.clip(g[..., None] + np.where(g[..., None] < 255, tint, 0), 0, 255)
    files["sketch_rgb8_227.png"] = encode_png(rgb, 2, 8)
    files["sketch_gray8_227.png"] = encode_png(line_art(rng, s, s), 0, 8)
    g4 = line_art(rng, s, s) // 17
    pal = np.stack([np.arange(16) * 17] * 3, -1)
    files["sketch_pal4_trns_227.png"] = encode_png(g4, 3, 4, palette=pal,
                                                   trns=[255] * 15 + [0])
    a = line_art(rng, s, s)
    files["sketch_rgba8_227.png"] = encode_png(
        np.stack([a, a, a, np.where(a < 255, 255, 0)], -1), 6, 8)
    g16 = line_art(rng, s, s) * 257 + rng.randint(0, 257, (s, s))
    files["sketch_rgb16_227.png"] = encode_png(np.stack([g16, g16, g16], -1).clip(0, 65535), 2, 16)
    files["sketch_gray16_227.png"] = encode_png(line_art(rng, s, s) * 2, 0, 16)
    files["sketch_gray1_227.png"] = encode_png((line_art(rng, s, s) > 127).astype(int), 0, 1)
    g = line_art(rng, s, s)
    files["sketch_adam7_rgb8_227.png"] = encode_png(np.stack([g, g, g], -1), 2, 8, interlace=True)
    files["cifar_rgb8_32.png"] = encode_png(rng.randint(0, 256, (32, 32, 3)), 2, 8)
    files["stl10_rgb8_96.png"] = encode_png(rng.randint(0, 256, (96, 96, 3)), 2, 8)
    files["png_named_as.jpg"] = encode_png(rng.randint(0, 256, (150, 200, 3)), 2, 8)
    whole = encode_png(np.stack([line_art(rng, s, s)] * 3, -1), 2, 8)
    files["truncated_n02103406_4068-1.png"] = whole[:len(whole) // 2]
    return files


def digest(a):
    a = np.ascontiguousarray(a, np.uint8)
    return {"shape": list(a.shape), "sha256": hashlib.sha256(a.tobytes()).hexdigest(),
            "sum": int(a.sum(dtype=np.int64))}


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
    from PIL import Image

    from fsvlm_tpu.data import transforms as jax_transforms
    from fsvlm_tpu.data.base_dataset import Datum
    from fsvlm_tpu.data.loader import RawDatasetWrapper

    expected, truncated = {}, []
    for name, data in _files(np.random.RandomState(SEED)).items():
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        try:
            full = Image.open(path).convert("RGB")
        except OSError:
            truncated.append(name)
            continue
        cache = RawDatasetWrapper([Datum(impath=path)], pre_size=PRE_SIZE)[0]["img"]
        view = jax_transforms._resize_center_crop(full, EVAL_SIZE,
                                                  jax_transforms._PIL_INTERP["bicubic"])
        expected[name] = {"full": digest(np.asarray(full)), "cache256": digest(cache),
                          "eval224": digest(np.asarray(view))}
    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump({"digests": expected, "truncated": truncated}, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(HERE, n)) for n in os.listdir(HERE))
    print(f"wrote {len(expected) + len(truncated)} fixtures and expected.json: {total} bytes "
          f"in {HERE}")


if __name__ == "__main__":
    main()
