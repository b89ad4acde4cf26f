"""Hand-written encoders of the image formats the port reads through its own
decoders besides JPEG and PNG: BMP, Netpbm, GIF and TIFF, written from numpy
arrays with struct and zlib (no Pillow), so that the layouts Pillow cannot
write are reachable: OS/2 and V2-V5 BMP headers, RLE4/RLE8 streams with
deltas and odd absolute runs, bitfields, plain Netpbm with comments, GIF
frames smaller than the screen with local tables, interlace and a table
left full, tiled, planar, predicted TIFF in both byte orders with
PackBits, new- and old-style LZW and Deflate, and associated alpha.

``make_fixtures.py`` writes the committed fixtures with them, and
``tests/test_torch_formats.py`` its run-time cases.
"""

import struct
import zlib

import numpy as np


# ------------------------------------------------------------------ BMP
def _bmp_rows(pixels, bits):
    """(h, w) indices or (h, w, 3|4) BGR(A) bytes to rows padded to 4 bytes,
    top row first."""
    a = np.asarray(pixels)
    h, w = a.shape[:2]
    if bits >= 16:
        raw = a.reshape(h, -1).astype(np.uint8) if bits != 16 else \
            a.astype("<u2").view(np.uint8).reshape(h, -1)
    else:
        per = 8 // bits
        n = -(-w // per) * per
        padded = np.zeros((h, n), np.uint8)
        padded[:, :w] = a
        shifts = (8 - bits * (1 + np.arange(per))).astype(np.uint8)
        raw = (padded.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)
    stride = ((w * bits + 31) >> 3) & ~3
    out = np.zeros((h, stride), np.uint8)
    out[:, :raw.shape[1]] = raw
    return out


def rle_encode(indices, rle4, *, deltas=(), absolute=True, eob=True):
    """An RLE8/RLE4 stream of (h, w) indices, bottom row first: encoded runs
    of one index, absolute runs of 3 or more pixels (of an even count for
    RLE4) where ``absolute``, an end of line after each row and an end of
    bitmap.  ``deltas``: (row, col, right, up) escapes written before pixel
    (row, col) of the file's row order, as Pillow reads them: two byte
    pairs, the second the offsets; the pixels they skip decode as index 0."""
    a = np.asarray(indices)[::-1]
    h, w = a.shape
    out = bytearray()
    skip = {(r, c): (dr, du) for r, c, dr, du in deltas}
    r = c = 0
    while r < h:
        if c >= w:
            out += b"\x00\x00"
            r, c = r + 1, 0
            continue
        if (r, c) in skip:
            dr, du = skip.pop((r, c))
            out += bytes([0, 2, dr, du, dr, du])
            r, c = r + du, c + dr
            continue
        row = [int(v) for v in a[r]]
        n = 1
        while c + n < w and n < 255 and row[c + n] == row[c] and (r, c + n) not in skip:
            n += 1
        m = 0
        if absolute and n < 3:
            m = 1
            while c + m < w and m < 254 and (r, c + m) not in skip and not (
                    c + m + 2 < w and row[c + m] == row[c + m + 1] == row[c + m + 2]):
                m += 1
            if rle4:
                m -= m % 2
            if m < (4 if rle4 else 3):
                m = 0
        if m:
            vals = row[c:c + m]
            body = bytes((vals[i] << 4) | vals[i + 1] for i in range(0, m, 2)) if rle4 else \
                bytes(vals)
            out += bytes([0, m]) + body + (b"\x00" if len(body) % 2 else b"")
            c += m
        else:
            out += bytes([n, row[c] * 17 if rle4 else row[c]])
            c += n
    if eob:
        out += b"\x00\x01"
    return bytes(out)


def encode_bmp(pixels, bits, *, header=40, compression=0, palette=None, colors=None,
               top_down=False, masks=None, rle=None, pad_offset=0):
    """A BMP file's bytes.  ``pixels``: (h, w) palette indices (bits <= 8)
    or (h, w, c) bytes in file order (B, G, R[, X/A]) for 24/32 bits, or
    (h, w) 16-bit words for 16 bits; ``palette``: (n, 3) RGB; ``colors``:
    biClrUsed as written (default: the palette's length, 0 if it is full);
    ``masks``: BITFIELDS masks (r, g, b[, a]); ``rle``: the RLE stream
    (compression 1/2) in place of rows; ``pad_offset``: bytes between the
    palette and the pixel data."""
    a = np.asarray(pixels)
    h, w = a.shape[:2]
    pal = b""
    if palette is not None:
        pal_rgb = np.asarray(palette, np.uint8)
        entry = 3 if header == 12 else 4
        rows = [bytes([b, g, r]) + (b"\x00" if entry == 4 else b"") for r, g, b in pal_rgb]
        pal = b"".join(rows)
    n_pal = 0 if palette is None else len(palette)
    if colors is None:
        colors = 0 if n_pal == (1 << bits) else n_pal
    data = rle if rle is not None else _bmp_rows(a if top_down else a[::-1], bits).tobytes()
    extra = b""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                           compression, len(data), 2835, 2835, colors, 0)
        if compression in (3, 6):
            m = list(masks) + [0] * (4 - len(masks))
            if header >= 52:
                info += struct.pack("<IIII", *m)[:header - 40]
            else:
                extra = struct.pack("<III", *m[:3])
        info += b"\x00" * (header - len(info))
    offset = 14 + len(info) + len(extra) + len(pal) + pad_offset
    body = info + extra + pal + b"\x00" * pad_offset + data
    return b"BM" + struct.pack("<IHHI", 14 + len(body), 0, 0, offset) + body


# ------------------------------------------------------------------ Netpbm
def encode_pnm(samples, kind, maxval=255, *, comments=False, plain_width=70):
    """A P1-P6 file's bytes.  ``samples``: (h, w) for P1/P2/P4/P5 (bitmaps:
    1 is black), (h, w, 3) for P3/P6; binary samples above 255 are 16-bit
    big-endian; ``comments``: comments in the header, inside a token too,
    and in a plain raster."""
    a = np.asarray(samples)
    h, w = a.shape[:2]
    if comments:
        head = f"P{kind}\n# made by a seeded generator\n{w} #width\n{h}".encode()
        if kind not in (1, 4):
            ms = str(maxval)
            head += f"\n#max\n{ms[:1]}#split\n{ms[1:]}".encode() if len(ms) > 1 else \
                f"\n{ms}".encode()
        head += b"\n"
    else:
        head = f"P{kind}\n{w} {h}\n".encode() + (b"" if kind in (1, 4) else f"{maxval}\n".encode())
    if kind == 4:
        per = -(-w // 8) * 8
        padded = np.zeros((h, per), np.uint8)
        padded[:, :w] = a
        return head + np.packbits(padded, axis=1).tobytes()
    if kind in (5, 6):
        return head + a.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    tokens = [str(int(v)) for v in a.reshape(-1)]
    lines, line = [], ""
    for i, t in enumerate(tokens):
        sep = "" if kind == 1 and i % 3 else " "
        if len(line) + len(t) + 1 > plain_width:
            lines.append(line)
            line = ""
        line += (sep if line else "") + t
    lines.append(line)
    if comments and len(lines) > 2:
        lines.insert(2, "# a comment in the raster")
    return head + "\n".join(lines).encode() + b"\n"


# ------------------------------------------------------------------ GIF
def lzw_gif(indices, min_code, *, clear_when_full=True):
    """GIF's LZW code stream of a flat index sequence, packed LSB first
    into sub-blocks of 255 bytes with the terminator; with
    ``clear_when_full`` False a full table is used on without a clear."""
    clear, end = 1 << min_code, (1 << min_code) + 1
    size = min_code + 1
    codes = [(clear, size)]
    if min_code == 1:
        # Pillow never widens 2-bit codes (its table starts past their
        # range), so a 1-bit stream it reads holds literals only
        codes += [(int(k), 2) for k in indices] + [(end, 2)]
        indices = ()
    table = {(i,): i for i in range(clear)}
    nxt = end + 1
    w = ()
    for k in indices:
        wk = w + (int(k),)
        if wk in table:
            w = wk
            continue
        codes.append((table[w], size))
        if nxt < 4096:
            table[wk] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        elif clear_when_full:
            codes.append((clear, size))
            table = {(i,): i for i in range(clear)}
            nxt, size = end + 1, min_code + 1
        w = (int(k),)
    if w:
        codes.append((table[w], size))
    if min_code != 1:
        codes.append((end, size))
    acc, nbits, out = 0, 0, bytearray()
    for c, s in codes:
        acc |= c << nbits
        nbits += s
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 255)
    blocks = b"".join(bytes([len(out[i:i + 255])]) + bytes(out[i:i + 255])
                      for i in range(0, len(out), 255))
    return blocks + b"\x00"


def _gif_table(palette, bits):
    t = np.zeros((1 << bits, 3), np.uint8)
    p = np.asarray(palette, np.uint8)
    t[:len(p)] = p
    return t.tobytes()


def encode_gif(indices, *, screen=None, offset=(0, 0), global_palette=None, local_palette=None,
               table_bits=None, min_code=8, interlace=False, transparency=None,
               background=0, clear_when_full=True, extensions=True):
    """A GIF's bytes, one frame of (h, w) indices.  ``screen``: the logical
    screen (w, h), default the frame's size; ``offset``: the frame's left and
    top; ``table_bits``: each table holds 2**table_bits entries (default
    the palette's size rounded up); ``transparency``: a graphic control
    extension's transparent index; ``extensions``: a comment and a
    NETSCAPE2.0 loop before the frame."""
    a = np.asarray(indices)
    h, w = a.shape
    sw, sh = screen or (w, h)

    def bits_for(p):
        return table_bits or max(1, int(np.ceil(np.log2(max(2, len(p))))))

    flags = 0
    gt = b""
    if global_palette is not None:
        gb = bits_for(global_palette)
        flags = 0x80 | (7 << 4) | (gb - 1)
        gt = _gif_table(global_palette, gb)
    out = b"GIF89a" + struct.pack("<HHBBB", sw, sh, flags, background, 0) + gt
    if extensions:
        out += b"!\xfe" + bytes([9]) + b"seeded 17" + b"\x00"
        out += b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    if transparency is not None:
        out += b"!\xf9\x04" + bytes([1, 10, 0, transparency]) + b"\x00"
    iflags = 0x40 if interlace else 0
    lt = b""
    if local_palette is not None:
        lb = bits_for(local_palette)
        iflags |= 0x80 | (lb - 1)
        lt = _gif_table(local_palette, lb)
    rows = a
    if interlace:
        order = list(range(0, h, 8)) + list(range(4, h, 8)) + list(range(2, h, 4)) + \
            list(range(1, h, 2))
        rows = a[order]
    out += b"," + struct.pack("<HHHHB", offset[0], offset[1], w, h, iflags) + lt
    out += bytes([min_code]) + lzw_gif(rows.reshape(-1), min_code,
                                       clear_when_full=clear_when_full)
    return out + b";"


# ------------------------------------------------------------------ TIFF
def packbits(data):
    """PackBits (TIFF compression 32773) of one row's bytes."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([(257 - (j - i + 1)) & 255, data[i]])
            i = j + 1
            continue
        j = i
        while j + 1 < n and data[j + 1] != data[j] and j - i < 127:
            j += 1
        if j + 1 < n and j > i:
            j -= 1
        out += bytes([j - i]) + bytes(data[i:j + 1])
        i = j + 1
    return bytes(out)


def lzw_tiff(data, old_style=False):
    """TIFF LZW (compression 5): MSB first with early change, or the old
    style libtiff still reads (LSB first, no early change)."""
    clear, eoi = 256, 257
    table = {bytes([i]): i for i in range(256)}
    nxt, size = 258, 9
    codes = [(clear, 9)]
    w = b""
    early = 0 if old_style else 1
    for k in data:
        wk = w + bytes([k])
        if wk in table:
            w = wk
            continue
        codes.append((table[w], size))
        table[wk] = nxt
        nxt += 1
        if nxt + early > (1 << size) and size < 12:
            size += 1
        if nxt >= 4094:
            codes.append((clear, size))
            table = {bytes([i]): i for i in range(256)}
            nxt, size = 258, 9
        w = bytes([k])
    if w:
        codes.append((table[w], size))
        nxt += 1
        if nxt + early > (1 << size) and size < 12:
            size += 1
    codes.append((eoi, size))
    acc, nbits, out = 0, 0, bytearray()
    for c, s in codes:
        if old_style:
            acc |= c << nbits
            nbits += s
            while nbits >= 8:
                out.append(acc & 255)
                acc >>= 8
                nbits -= 8
        else:
            acc = (acc << s) | c
            nbits += s
            while nbits >= 8:
                out.append((acc >> (nbits - 8)) & 255)
                nbits -= 8
            acc &= (1 << nbits) - 1
    if nbits:
        out.append((acc << (8 - nbits)) & 255 if not old_style else acc & 255)
    return bytes(out)


def _pack_samples(block, bits, order):
    """(rows, cols, spp) samples to each row's bytes: 32 bits as the array's
    kind (float32, int32 or uint32), 16, 12 (two samples in three bytes, high
    nibble first), 8 or fewer bits packed MSB first."""
    r, c, s = block.shape
    flat = block.reshape(r, c * s)
    if bits == 32:
        kind = {"f": "f4", "i": "i4"}.get(flat.dtype.kind, "u4")
        return [row.astype(order + kind).tobytes() for row in flat]
    if bits == 16:
        kind = "i2" if flat.dtype.kind == "i" else "u2"
        return [row.astype(order + kind).tobytes() for row in flat]
    if bits == 8:
        return [row.astype(np.uint8).tobytes() for row in flat]
    if bits == 12:
        n = flat.shape[1] + flat.shape[1] % 2
        v = np.zeros((r, n), np.int64)
        v[:, :flat.shape[1]] = flat
        a, b = v[:, 0::2], v[:, 1::2]
        out = np.stack([a >> 4, ((a & 15) << 4) | (b >> 8), b & 255], -1).reshape(r, -1)
        return [bytes(x) for x in out[:, :(flat.shape[1] * 12 + 7) // 8].astype(np.uint8)]
    per = 8 // bits
    n = -(-flat.shape[1] // per) * per
    padded = np.zeros((r, n), np.uint8)
    padded[:, :flat.shape[1]] = flat
    shifts = (8 - bits * (1 + np.arange(per))).astype(np.uint8)
    return [bytes(x) for x in (padded.reshape(r, -1, per) << shifts).sum(-1).astype(np.uint8)]


def _predict(block, bits):
    """Horizontal differencing (Predictor 2) of (rows, cols, spp) samples."""
    if bits == 32 and block.dtype.kind == "f":  # the floats' bit patterns
        b = block.astype("<f4").view("<u4").astype(np.int64)
    else:
        b = block.astype(np.int64)
    d = b.copy()
    d[:, 1:] = b[:, 1:] - b[:, :-1]
    return d & ((1 << bits) - 1)


_REVERSED = [int(f"{b:08b}"[::-1], 2) for b in range(256)]


def _fp_predict(block):
    """The floating-point predictor (Predictor 3) of (rows, cols, spp)
    float32 samples: each row's bytes regrouped most significant first
    (all the samples' high bytes, then the next ...), then differenced byte
    by byte at a distance of spp bytes."""
    r, c, s = block.shape
    rows = []
    for row in block.reshape(r, c * s).astype("<f4"):
        b = np.frombuffer(row.tobytes(), np.uint8).reshape(-1, 4)
        planes = np.concatenate([b[:, 3 - j] for j in range(4)]).astype(np.int64)
        planes[s:] = planes[s:] - planes[:-s]
        rows.append(bytes((planes & 255).astype(np.uint8)))
    return rows


def _ycbcr_blocks(block, hs, vs):
    """(rows, cols, 3) YCbCr samples as TIFF's subsampled blocks: for each
    hs x vs block (edge blocks padded with their last row and column), its
    hs * vs Y values, then the block's mean Cb and Cr; one row of bytes per
    row of blocks."""
    r, c, _ = block.shape
    pr, pc = -(-r // vs) * vs, -(-c // hs) * hs
    a = np.pad(block.astype(np.int64), ((0, pr - r), (0, pc - c), (0, 0)), mode="edge")
    a = a.reshape(pr // vs, vs, pc // hs, hs, 3).transpose(0, 2, 1, 3, 4)
    y = a[..., 0].reshape(pr // vs, pc // hs, hs * vs)
    chroma = np.rint(a[..., 1:].reshape(pr // vs, pc // hs, hs * vs, 2).mean(2)).astype(np.int64)
    return [bytes(row.astype(np.uint8)) for row in
            np.concatenate([y, chroma], -1).reshape(pr // vs, -1)]


def encode_tiff(samples, photometric, *, bits=8, order="<", compression=1, predictor=1,
                tile=None, rows_per_strip=None, planar=1, extra=None, colormap=None,
                orientation=None, fillorder=None, lzw_old_style=False, sample_format=None,
                big=False, ycbcr=None, ref_bw=None, luma=None, jpeg=None, jpeg_tables=None,
                extra_tags=None):
    """A TIFF's bytes: one IFD over (h, w, spp) samples.  ``compression``:
    1, 5 (LZW), 8 or 32946 (Deflate), 32773 (PackBits), 7 (JPEG: ``jpeg``
    turns each strip's or tile's samples into its stream, ``jpeg_tables``
    the JPEGTables bytes); ``tile``: (tw, th) tiles, else strips of
    ``rows_per_strip`` rows; ``planar``: 1 or 2; ``extra``: ExtraSamples
    values; ``colormap``: (3, 2**bits) 16-bit; ``sample_format``: the
    SampleFormat of every sample (the array's kind sets the bytes at 16
    and 32 bits); ``big``: BigTIFF (8-byte offsets, 20-byte entries);
    ``ycbcr``: (hs, vs) YCbCrSubsampling, YCbCr samples packed in blocks;
    ``ref_bw`` / ``luma``: ReferenceBlackWhite / YCbCrCoefficients as
    (numerator, denominator) pairs; ``extra_tags``: {tag: (type, values)}."""
    a = np.asarray(samples)
    if a.ndim == 2:
        a = a[..., None]
    h, w, spp = a.shape
    planes = [a[..., i:i + 1] for i in range(spp)] if planar == 2 else [a]
    segs = []
    if tile:
        tw, th = tile
        for plane in planes:
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    blk = np.zeros((th, tw, plane.shape[2]), a.dtype)
                    part = plane[y:y + th, x:x + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    segs.append(blk)
    else:
        rps = rows_per_strip or h
        for plane in planes:
            for y in range(0, h, rps):
                segs.append(plane[y:y + rps])
    chunks = []
    for blk in segs:
        if jpeg is not None:
            chunks.append(jpeg(blk))
            continue
        if ycbcr:
            rows = _ycbcr_blocks(blk, *ycbcr)
        elif predictor == 3:
            rows = _fp_predict(blk)
        else:
            if predictor == 2:
                blk = _predict(blk, bits).astype(np.uint32 if bits == 32 else np.int64)
            rows = _pack_samples(blk, bits, ">" if order == ">" else "<")
        raw = b"".join(rows)
        if compression == 1:
            chunks.append(raw)
            continue
        if compression == 32773:
            coded = b"".join(packbits(r) for r in rows)
        elif compression == 5:
            coded = lzw_tiff(raw, lzw_old_style)
        else:
            coded = zlib.compress(raw, 6)
        if fillorder == 2:  # the coded bytes least significant bit first
            coded = bytes(_REVERSED[b] for b in coded)
        chunks.append(coded)
    tags = {256: (3, [w]), 257: (3, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra is not None:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, [int(v) for v in np.asarray(colormap).reshape(-1)])
    if orientation is not None:
        tags[274] = (3, [orientation])
    if fillorder is not None:
        tags[266] = (3, [fillorder])
    if sample_format is not None:
        tags[339] = (3, [sample_format] * spp)
    if ycbcr:
        tags[530] = (3, list(ycbcr))
    if ref_bw is not None:
        tags[532] = (5, list(ref_bw))
    if luma is not None:
        tags[529] = (5, list(luma))
    if jpeg_tables is not None:
        tags[347] = (7, jpeg_tables)
    tags.update(extra_tags or {})
    body = bytearray()
    offsets = []
    base = 16 if big else 8
    for c in chunks:
        offsets.append(base + len(body))
        body += c
        if len(body) % 2:
            body += b"\x00"
    off_type = 16 if big else 4
    if tile:
        tags[322] = (3, [tile[0]])
        tags[323] = (3, [tile[1]])
        tags[324] = (off_type, offsets)
        tags[325] = (off_type, [len(c) for c in chunks])
    else:
        tags[273] = (off_type, offsets)
        tags[278] = (3, [rows_per_strip or h])
        tags[279] = (off_type, [len(c) for c in chunks])
    ifd_at = base + len(body)
    entries = sorted(tags.items())
    cell, count_fmt, n_fmt = (8, "Q", "Q") if big else (4, "I", "H")
    ifd_len = struct.calcsize(order + n_fmt) + (4 + struct.calcsize(count_fmt) + cell) * len(
        entries) + cell
    data_at = ifd_at + ifd_len
    ifd, extra_data = bytearray(struct.pack(order + n_fmt, len(entries))), bytearray()
    for tag, (typ, vals) in entries:
        if typ == 7:
            payload, count = bytes(vals), len(vals)
        elif typ == 5:
            flat = [x for v in vals for x in v]  # (numerator, denominator) pairs
            payload, count = struct.pack(order + "II" * len(vals), *flat), len(vals)
        else:
            fmt = {3: "H", 4: "I", 16: "Q"}[typ]
            payload, count = struct.pack(order + fmt * len(vals), *vals), len(vals)
        head = struct.pack(order + "HH" + count_fmt, tag, typ, count)
        if len(payload) <= cell:
            ifd += head + payload.ljust(cell, b"\x00")
        else:
            ifd += head + struct.pack(order + ("Q" if big else "I"), data_at + len(extra_data))
            extra_data += payload
            if len(extra_data) % 2:
                extra_data += b"\x00"
    ifd += struct.pack(order + ("Q" if big else "I"), 0)
    if big:
        head = (b"II+\x00" if order == "<" else b"MM\x00+") + struct.pack(order + "HHQ", 8, 0,
                                                                          ifd_at)
    else:
        head = (b"II*\x00" if order == "<" else b"MM\x00*") + struct.pack(order + "I", ifd_at)
    return head + bytes(body) + bytes(ifd) + bytes(extra_data)


def jpeg_parts(stream):
    """A whole JPEG stream split as JPEG-in-TIFF writers split it: the
    JPEGTables stream (SOI, the DQT and DHT segments, EOI) and the
    abbreviated image stream (SOI, every other segment, the scans, EOI)."""
    tables, image, pos = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while pos < len(stream):
        marker = stream[pos + 1]
        if marker == 0xDA:  # the scans to the end
            image += stream[pos:]
            break
        n = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        seg = stream[pos:pos + 2 + n]
        if marker in (0xDB, 0xC4):
            tables += seg
        elif not 0xE0 <= marker <= 0xEF:  # APPn markers dropped, as libtiff writes none
            image += seg
        pos += 2 + n
    return bytes(tables + b"\xff\xd9"), bytes(image)


# ------------------------------------------------------------------ lossless JPEG
_DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]  # T.81 K.3, categories 0-11


def _lossless_codes():
    counts = list(_DC_BITS)
    counts[11] += 5  # categories 12-16 as 12-bit codes
    vals = list(range(17))
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[vals[k]] = (code, length)
            k += 1
            code += 1
        code <<= 1
    return counts, vals, codes


def _predict_lossless(ra, rb, rc, predictor):
    return [None, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
            (ra + rb) >> 1][predictor]


def encode_lossless_jpeg(samples, *, predictor=1, pt=0, restart_rows=0, jfif=False, ids=None):
    """A lossless (SOF3, Huffman) JPEG of (h, w) or (h, w, c) 8-bit samples,
    one interleaved scan with the given predictor (1-7) and point transform,
    restart markers every ``restart_rows`` rows; ``jfif``: a JFIF APP0
    (three components then read as YCbCr); ``ids``: the component IDs."""
    a = np.asarray(samples, np.int64)
    if a.ndim == 2:
        a = a[..., None]
    h, w, nc = a.shape
    a = a >> pt
    counts, vals, codes = _lossless_codes()
    ids = ids or list(range(1, nc + 1))

    def seg(marker, body):
        return b"\xff" + bytes([marker]) + struct.pack(">H", len(body) + 2) + body

    out = b"\xff\xd8"
    if jfif:
        out += seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += seg(0xC3, struct.pack(">BHHB", 8, h, w, nc) +
               b"".join(bytes([ids[i], 0x11, 0]) for i in range(nc)))
    out += seg(0xC4, bytes([0]) + bytes(counts) + bytes(vals))
    if restart_rows:
        out += seg(0xDD, struct.pack(">H", restart_rows * w))
    out += seg(0xDA, bytes([nc]) + b"".join(bytes([ids[i], 0]) for i in range(nc)) +
               bytes([predictor, 0, pt]))
    bits, data = [], bytearray()

    def flush():
        while len(bits) % 8:
            bits.append(1)
        for i in range(0, len(bits), 8):
            byte = int("".join(map(str, bits[i:i + 8])), 2)
            data.append(byte)
            if byte == 0xFF:
                data.append(0)
        bits.clear()

    first, rst = True, 0
    for y in range(h):
        if restart_rows and y and y % restart_rows == 0:
            flush()
            data.extend(bytes([0xFF, 0xD0 + rst]))
            rst = (rst + 1) % 8
            first = True
        for x in range(w):
            for c in range(nc):
                v = int(a[y, x, c])
                if first:
                    p = (1 << (8 - pt - 1)) if x == 0 else int(a[y, x - 1, c])
                elif x == 0:
                    p = int(a[y - 1, x, c])
                else:
                    p = _predict_lossless(int(a[y, x - 1, c]), int(a[y - 1, x, c]),
                                          int(a[y - 1, x - 1, c]), predictor)
                d = (v - p) & 0xFFFF
                d = d - 0x10000 if d >= 0x8000 else d
                s = 0 if d == 0 else (16 if d == -32768 else abs(d).bit_length())
                code, length = codes[s]
                bits.extend(int(b) for b in format(code, f"0{length}b"))
                if s and s < 16:
                    bits.extend(int(b) for b in format(d if d > 0 else d + (1 << s) - 1, f"0{s}b"))
        first = False
    flush()
    return out + bytes(data) + b"\xff\xd9"
