"""Color / geometry augmentation extensions — the port of
``bigdl_tpu.data.augmentation``.  Host-CPU numpy (the device sees the
finished float batch); the same seeds draw the same augmentations as the
JAX package.

All ops take/return uint8 HWC ImageFeatures except where stated."""

from typing import Optional, Sequence

import numpy as np

from bigdl_tpu_torch import native
from bigdl_tpu_torch.data.transformer import Transformer
from bigdl_tpu_torch.data.vision import _PerImage


def _clip_u8(x) -> np.ndarray:
    return np.clip(x, 0, 255).astype(np.uint8)


class Brightness(_PerImage):
    """Add a uniform delta in [delta_low, delta_high] (0-255 scale)."""

    def __init__(self, delta_low: float = -32.0, delta_high: float = 32.0,
                 seed: Optional[int] = None):
        self.low, self.high = delta_low, delta_high
        self.rng = np.random.default_rng(seed)

    def transform_one(self, f):
        d = self.rng.uniform(self.low, self.high)
        f.image = _clip_u8(f.image.astype(np.float32) + d)
        return f


class Contrast(_PerImage):
    """Scale around the per-image mean by a factor in [low, high]."""

    def __init__(self, low: float = 0.5, high: float = 1.5,
                 seed: Optional[int] = None):
        self.low, self.high = low, high
        self.rng = np.random.default_rng(seed)

    def transform_one(self, f):
        c = self.rng.uniform(self.low, self.high)
        x = f.image.astype(np.float32)
        f.image = _clip_u8((x - x.mean()) * c + x.mean())
        return f


class Saturation(_PerImage):
    """Interpolate between grayscale and the image by [low, high]."""

    def __init__(self, low: float = 0.5, high: float = 1.5,
                 seed: Optional[int] = None):
        self.low, self.high = low, high
        self.rng = np.random.default_rng(seed)

    def transform_one(self, f):
        s = self.rng.uniform(self.low, self.high)
        x = f.image.astype(np.float32)
        gray = (0.299 * x[..., 0] + 0.587 * x[..., 1]
                + 0.114 * x[..., 2])[..., None]
        f.image = _clip_u8(gray + (x - gray) * s)
        return f


class Hue(_PerImage):
    """Rotate hue by a delta in [-delta, delta] degrees (RGB↔HSV on host)."""

    def __init__(self, delta: float = 18.0, seed: Optional[int] = None):
        self.delta = delta
        self.rng = np.random.default_rng(seed)

    def transform_one(self, f):
        d = self.rng.uniform(-self.delta, self.delta) / 360.0
        x = f.image.astype(np.float32) / 255.0
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        mx = x.max(-1)
        mn = x.min(-1)
        diff = mx - mn + 1e-12
        h = np.zeros_like(mx)
        mask = mx == r
        h[mask] = ((g - b) / diff)[mask] % 6
        mask = mx == g
        h[mask] = ((b - r) / diff + 2)[mask]
        mask = mx == b
        h[mask] = ((r - g) / diff + 4)[mask]
        h = (h / 6.0 + d) % 1.0
        s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
        v = mx
        # HSV → RGB (vectorized)
        i = np.floor(h * 6.0)
        fpart = h * 6.0 - i
        p = v * (1 - s)
        q = v * (1 - fpart * s)
        t = v * (1 - (1 - fpart) * s)
        i = i.astype(np.int32) % 6
        out = np.zeros_like(x)
        for k, (rr, gg, bb) in enumerate(
                [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
                 (v, p, q)]):
            m = i == k
            out[..., 0][m] = rr[m]
            out[..., 1][m] = gg[m]
            out[..., 2][m] = bb[m]
        f.image = _clip_u8(out * 255.0)
        return f


class ColorJitter(Transformer):
    """Brightness+contrast+saturation (and optional hue) in random order —
    reference ``augmentation/ColorJitter.scala``."""

    def __init__(self, brightness: float = 32.0, contrast: float = 0.5,
                 saturation: float = 0.5, hue: float = 0.0,
                 seed: Optional[int] = None):
        # independent per-stage streams — one shared seed would correlate
        # the brightness/contrast/saturation draws
        spawn = np.random.SeedSequence(seed).spawn(5)
        self.stages = [
            Brightness(-brightness, brightness, spawn[0]),
            Contrast(1 - contrast, 1 + contrast, spawn[1]),
            Saturation(1 - saturation, 1 + saturation, spawn[2]),
        ]
        if hue > 0:
            self.stages.append(Hue(hue, spawn[3]))
        self.rng = np.random.default_rng(spawn[4])

    def apply(self, it):
        for f in it:
            order = self.rng.permutation(len(self.stages))
            for k in order:
                f = self.stages[k].transform_one(f)
            yield f


class ChannelOrder(_PerImage):
    """RGB↔BGR swap — reference ``augmentation/ChannelOrder.scala`` (the
    reference pipeline is BGR-native from OpenCV; ours RGB-native)."""

    def transform_one(self, f):
        f.image = f.image[..., ::-1]
        return f


class Grayscale(_PerImage):
    def transform_one(self, f):
        x = f.image.astype(np.float32)
        gray = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
        f.image = _clip_u8(np.repeat(gray[..., None], 3, axis=-1))
        return f


class Expand(_PerImage):
    """Place the image on a larger filled canvas (zoom-out) — reference
    ``augmentation/Expand.scala`` (SSD-style)."""

    def __init__(self, max_ratio: float = 2.0,
                 fill: Sequence[float] = (123, 117, 104),
                 seed: Optional[int] = None):
        self.max_ratio = max_ratio
        self.fill = np.asarray(fill, np.uint8)
        self.rng = np.random.default_rng(seed)

    def transform_one(self, f):
        h, w, c = f.image.shape
        ratio = self.rng.uniform(1.0, self.max_ratio)
        nh, nw = int(h * ratio), int(w * ratio)
        oy = int(self.rng.integers(0, nh - h + 1))
        ox = int(self.rng.integers(0, nw - w + 1))
        canvas = np.empty((nh, nw, c), np.uint8)
        canvas[:] = self.fill
        canvas[oy:oy + h, ox:ox + w] = f.image
        f.image = canvas
        return f


class Filler(_PerImage):
    """Fill a normalized-coordinate region with a value — reference
    ``augmentation/Filler.scala`` (a cutout-style eraser)."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float,
                 value: int = 255):
        self.box = (x1, y1, x2, y2)
        self.value = value

    def transform_one(self, f):
        h, w, _ = f.image.shape
        x1, y1, x2, y2 = self.box
        img = f.image.copy()
        img[int(y1 * h):int(y2 * h), int(x1 * w):int(x2 * w)] = self.value
        f.image = img
        return f


class FixedCrop(_PerImage):
    """Crop by normalized coordinates — reference ``augmentation/FixedCrop``."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float):
        self.box = (x1, y1, x2, y2)

    def transform_one(self, f):
        h, w, _ = f.image.shape
        x1, y1, x2, y2 = self.box
        f.image = f.image[int(y1 * h):int(y2 * h), int(x1 * w):int(x2 * w)]
        return f


class AspectScale(_PerImage):
    """Scale the short side to ``size`` capping the long side — reference
    ``augmentation/AspectScale.scala`` (Faster-RCNN style)."""

    def __init__(self, size: int, max_size: int = 1000):
        self.size = size
        self.max_size = max_size

    def transform_one(self, f):
        h, w, _ = f.image.shape
        scale = self.size / min(h, w)
        if round(scale * max(h, w)) > self.max_size:
            scale = self.max_size / max(h, w)
        f.image = native.resize_bilinear(
            f.image, max(1, int(round(h * scale))),
            max(1, int(round(w * scale))))
        return f


class RandomAspectScale(AspectScale):
    """AspectScale with the target sampled from ``scales`` per image."""

    def __init__(self, scales: Sequence[int], max_size: int = 1000,
                 seed: Optional[int] = None):
        super().__init__(scales[0], max_size)
        self.scales = list(scales)
        self.rng = np.random.default_rng(seed)

    def transform_one(self, f):
        self.size = int(self.rng.choice(self.scales))
        return super().transform_one(f)


class PixelNormalizer(_PerImage):
    """Subtract a full per-pixel mean image (float output) — reference
    ``augmentation/PixelNormalizer.scala``."""

    def __init__(self, mean_image: np.ndarray):
        self.mean_image = np.asarray(mean_image, np.float32)

    def transform_one(self, f):
        f.image = f.image.astype(np.float32) - self.mean_image
        return f


class RandomTransformer(Transformer):
    """Apply an inner transformer with probability p — reference
    ``augmentation/RandomTransformer.scala``."""

    def __init__(self, inner: Transformer, p: float,
                 seed: Optional[int] = None):
        self.inner = inner
        self.p = p
        self.rng = np.random.default_rng(seed)

    def apply(self, it):
        for f in it:
            if self.rng.random() < self.p:
                f = next(iter(self.inner(iter([f]))))
            yield f
