"""Segmentation dataset utilities: COCO-style RLE and polygon masks —
the port of ``bigdl_tpu.data.segmentation``.  Host-CPU numpy (PIL for the
polygon fill); masks go to the device as dense uint8/float arrays."""

from typing import Dict, List, Sequence, Union

import numpy as np


def rle_encode(mask: np.ndarray) -> Dict:
    """Binary (H, W) mask → COCO *uncompressed* RLE dict
    ``{"counts": [...], "size": [H, W]}`` (column-major order, starting with
    the count of zeros, matching pycocotools' convention)."""
    m = np.asarray(mask, np.uint8)
    flat = m.flatten(order="F")
    # run lengths, first run is zeros (possibly length 0)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    counts = list(map(int, runs))
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    return {"counts": counts, "size": [int(m.shape[0]), int(m.shape[1])]}


def _coco_string_to_counts(s: Union[str, bytes]) -> List[int]:
    """Decode COCO *compressed* RLE counts (pycocotools ``rleFrString``):
    5-bit varint chunks (char = chunk+48, bit 0x20 = continuation, 0x10 in
    the last chunk = sign extension), delta-coded against counts[i-2]."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    p = 0
    while p < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_decode(rle: Dict) -> np.ndarray:
    """COCO RLE dict → binary (H, W) uint8 mask.  Accepts both uncompressed
    (list ``counts``) and compressed (string ``counts``, the iscrowd=1 form
    in real COCO JSON) encodings."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _coco_string_to_counts(counts)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((w, h)).T  # column-major


def rle_area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _coco_string_to_counts(counts)
    return int(sum(counts[1::2]))


def polygons_to_mask(polygons: Sequence[Sequence[float]], height: int,
                     width: int) -> np.ndarray:
    """COCO polygon list ([x0,y0,x1,y1,...] per ring) → (H, W) uint8 mask."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (width, height), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        pts = [(float(poly[i]), float(poly[i + 1]))
               for i in range(0, len(poly), 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, np.uint8)


def mask_to_bbox(mask: np.ndarray) -> List[float]:
    """Tight [x, y, w, h] bbox of a binary mask (COCO bbox convention)."""
    ys, xs = np.nonzero(np.asarray(mask))
    if len(ys) == 0:
        return [0.0, 0.0, 0.0, 0.0]
    x0, x1 = float(xs.min()), float(xs.max())
    y0, y1 = float(ys.min()), float(ys.max())
    return [x0, y0, x1 - x0 + 1.0, y1 - y0 + 1.0]


def annotation_to_mask(ann: Dict, height: int, width: int) -> np.ndarray:
    """COCO annotation dict (``segmentation`` = polygons or RLE) → mask."""
    seg: Union[Dict, List] = ann["segmentation"]
    if isinstance(seg, dict):
        return rle_decode(seg)
    return polygons_to_mask(seg, height, width)
