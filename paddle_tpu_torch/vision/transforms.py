"""Image transforms (counterpart of paddle_tpu/vision/transforms.py).

numpy on HWC images, on the host: they run in the loader's workers, not
on the card. The random ones draw from Python's `random` and numpy's
global stream exactly where the reference's do, so a run seeded alike
crops, flips and jitters alike. ToTensor gives a CHW float32 array; the
collate makes the tensor."""
from __future__ import annotations

import numbers
import random

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __call__(self, img):
        raise NotImplementedError


def _as_hwc(img):
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[:, :, None]
    return a


class ToTensor(BaseTransform):
    """HWC uint8 -> CHW float32 in [0,1]."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        a = _as_hwc(img).astype("float32")
        if a.max() > 1.5:
            a = a / 255.0
        if self.data_format == "CHW":
            a = a.transpose(2, 0, 1)
        return a


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, "float32")
        self.std = np.asarray(std, "float32")
        self.data_format = data_format

    def __call__(self, img):
        a = np.asarray(img, dtype="float32")
        shape = (-1, 1, 1) if self.data_format == "CHW" else (1, 1, -1)
        return (a - self.mean.reshape(shape)) / self.std.reshape(shape)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, numbers.Number) else size

    def __call__(self, img):
        a = _as_hwc(img)
        h, w = self.size
        ys = (np.arange(h) * a.shape[0] / h).astype(int)
        xs = (np.arange(w) * a.shape[1] / w).astype(int)
        return a[ys][:, xs]


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, numbers.Number) else size

    def __call__(self, img):
        a = _as_hwc(img)
        th, tw = self.size
        i = max((a.shape[0] - th) // 2, 0)
        j = max((a.shape[1] - tw) // 2, 0)
        return a[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False):
        self.size = (size, size) if isinstance(size, numbers.Number) else size
        self.padding = padding

    def __call__(self, img):
        a = _as_hwc(img)
        if self.padding:
            p = self.padding
            a = np.pad(a, [(p, p), (p, p), (0, 0)])
        th, tw = self.size
        i = random.randint(0, max(a.shape[0] - th, 0))
        j = random.randint(0, max(a.shape[1] - tw, 0))
        return a[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if random.random() < self.prob:
            return _as_hwc(img)[:, ::-1]
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if random.random() < self.prob:
            return _as_hwc(img)[::-1]
        return img


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return _as_hwc(img).transpose(self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        a = _as_hwc(img).astype("float32")
        alpha = 1 + np.random.uniform(-self.value, self.value)
        return np.clip(a * alpha, 0, 255 if a.max() > 1.5 else 1.0)


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW"):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return _as_hwc(img)[:, ::-1]


def vflip(img):
    return _as_hwc(img)[::-1]


# ------------------------------------------------- functional (widening) --
def crop(img, top, left, height, width):
    """(reference vision/transforms/functional.py crop)."""
    return _as_hwc(img)[top:top + height, left:left + width]


def center_crop(img, output_size):
    a = _as_hwc(img)
    oh, ow = (output_size, output_size) if isinstance(
        output_size, numbers.Number) else tuple(output_size)
    top = max((a.shape[0] - oh) // 2, 0)
    left = max((a.shape[1] - ow) // 2, 0)
    return a[top:top + oh, left:left + ow]


def pad(img, padding, fill=0, padding_mode="constant"):
    a = _as_hwc(img)
    if isinstance(padding, numbers.Number):
        pl = pr = pt = pb = int(padding)
    elif len(padding) == 2:
        pl = pr = int(padding[0])
        pt = pb = int(padding[1])
    else:
        pl, pt, pr, pb = [int(p) for p in padding]
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if mode == "constant" else {}
    return np.pad(a, [(pt, pb), (pl, pr), (0, 0)], mode=mode, **kw)


def erase(img, i, j, h, w, v, inplace=False):
    a = _as_hwc(img)
    if not inplace:
        a = a.copy()
    a[i:i + h, j:j + w] = v
    return a


def to_grayscale(img, num_output_channels=1):
    a = _as_hwc(img).astype("float32")
    g = (0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2])
    g = np.repeat(g[..., None], num_output_channels, axis=-1)
    return g.astype(np.asarray(img).dtype)


def adjust_brightness(img, brightness_factor):
    a = _as_hwc(img)
    hi = 255 if a.dtype == np.uint8 else 1.0
    return np.clip(a.astype("float32") * brightness_factor, 0, hi) \
        .astype(a.dtype)


def adjust_contrast(img, contrast_factor):
    a = _as_hwc(img)
    hi = 255 if a.dtype == np.uint8 else 1.0
    mean = to_grayscale(a).astype("float32").mean()
    out = mean + contrast_factor * (a.astype("float32") - mean)
    return np.clip(out, 0, hi).astype(a.dtype)


def adjust_saturation(img, saturation_factor):
    a = _as_hwc(img)
    hi = 255 if a.dtype == np.uint8 else 1.0
    g = to_grayscale(a, 3).astype("float32")
    out = g + saturation_factor * (a.astype("float32") - g)
    return np.clip(out, 0, hi).astype(a.dtype)


def adjust_hue(img, hue_factor):
    """Shift hue by hue_factor (in [-0.5, 0.5]) via HSV round trip."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    a = _as_hwc(img)
    hi = 255.0 if a.dtype == np.uint8 else 1.0
    x = a.astype("float32") / hi
    mx = x.max(-1)
    mn = x.min(-1)
    d = mx - mn
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    h = np.zeros_like(mx)
    nz = d > 1e-8
    idx = nz & (mx == r)
    h[idx] = (((g - b) / d) % 6)[idx]
    idx = nz & (mx == g)
    h[idx] = (((b - r) / d) + 2)[idx]
    idx = nz & (mx == b)
    h[idx] = (((r - g) / d) + 4)[idx]
    h = (h / 6.0 + hue_factor) % 1.0
    s = np.where(mx > 1e-8, d / np.maximum(mx, 1e-8), 0.0)
    v = mx
    # hsv -> rgb
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i.astype("int32") % 6
    out = np.zeros_like(x)
    for k, (rr, gg, bb) in enumerate([(v, t, p), (q, v, p), (p, v, t),
                                      (p, q, v), (t, p, v), (v, p, q)]):
        m = i == k
        out[..., 0][m] = rr[m]
        out[..., 1][m] = gg[m]
        out[..., 2][m] = bb[m]
    return np.clip(out * hi, 0, hi).astype(a.dtype)


def _inverse_warp(img, inv_matrix, out_shape=None, fill=0):
    """Bilinear inverse warp by a 3x3 homography (numpy, on the host)."""
    a = _as_hwc(img).astype("float32")
    h, w = (out_shape or a.shape[:2])
    ys, xs = np.meshgrid(np.arange(h, dtype="float32"),
                         np.arange(w, dtype="float32"), indexing="ij")
    ones = np.ones_like(xs)
    coords = np.stack([xs, ys, ones], 0).reshape(3, -1)
    src = inv_matrix @ coords
    sx = src[0] / np.maximum(np.abs(src[2]), 1e-8) * np.sign(src[2])
    sy = src[1] / np.maximum(np.abs(src[2]), 1e-8) * np.sign(src[2])
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    wx = sx - x0
    wy = sy - y0

    def tap(yy, xx):
        valid = (yy >= 0) & (yy < a.shape[0]) & (xx >= 0) & (xx < a.shape[1])
        yc = np.clip(yy, 0, a.shape[0] - 1).astype("int32")
        xc = np.clip(xx, 0, a.shape[1] - 1).astype("int32")
        val = a[yc, xc]
        val[~valid] = fill
        return val

    out = (tap(y0, x0) * ((1 - wx) * (1 - wy))[:, None]
           + tap(y0, x0 + 1) * (wx * (1 - wy))[:, None]
           + tap(y0 + 1, x0) * ((1 - wx) * wy)[:, None]
           + tap(y0 + 1, x0 + 1) * (wx * wy)[:, None])
    out = out.reshape(h, w, a.shape[2])
    return np.clip(out, 0, 255 if _as_hwc(img).dtype == np.uint8 else 1.0) \
        .astype(_as_hwc(img).dtype)


def _affine_matrix(angle, translate, scale, shear, center):
    import math as _m

    rot = _m.radians(angle)
    sx, sy = [_m.radians(s) for s in (shear if isinstance(
        shear, (list, tuple)) else (shear, 0.0))]
    cx, cy = center
    tx, ty = translate
    # M = T(center) T(translate) R(angle) Shear Scale T(-center)
    a = _m.cos(rot - sy) / _m.cos(sy)
    b = -_m.cos(rot - sy) * _m.tan(sx) / _m.cos(sy) - _m.sin(rot)
    c = _m.sin(rot - sy) / _m.cos(sy)
    d = -_m.sin(rot - sy) * _m.tan(sx) / _m.cos(sy) + _m.cos(rot)
    M = np.array([[scale * a, scale * b, 0],
                  [scale * c, scale * d, 0],
                  [0, 0, 1]], "float32")
    T1 = np.array([[1, 0, cx + tx], [0, 1, cy + ty], [0, 0, 1]], "float32")
    T2 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], "float32")
    return T1 @ M @ T2


def affine(img, angle=0.0, translate=(0, 0), scale=1.0, shear=(0.0, 0.0),
           interpolation="bilinear", fill=0, center=None):
    a = _as_hwc(img)
    h, w = a.shape[:2]
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    M = _affine_matrix(angle, translate, scale, shear, center)
    return _inverse_warp(a, np.linalg.inv(M), fill=fill)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    a = _as_hwc(img)
    h, w = a.shape[:2]
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    M = _affine_matrix(angle, (0, 0), 1.0, (0.0, 0.0), center)
    out_shape = None
    if expand:
        corners = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1],
                            [w - 1, h - 1, 1]], "float32").T
        mapped = M @ corners
        nw = int(np.ceil(mapped[0].max() - mapped[0].min() + 1))
        nh = int(np.ceil(mapped[1].max() - mapped[1].min() + 1))
        shift = np.array([[1, 0, (nw - w) / 2], [0, 1, (nh - h) / 2],
                          [0, 0, 1]], "float32")
        M = shift @ M
        out_shape = (nh, nw)
    return _inverse_warp(a, np.linalg.inv(M), out_shape=out_shape,
                         fill=fill)


def _perspective_coeffs(startpoints, endpoints):
    mat = []
    rhs = []
    for (sx, sy), (ex, ey) in zip(startpoints, endpoints):
        mat.append([sx, sy, 1, 0, 0, 0, -ex * sx, -ex * sy])
        rhs.append(ex)
        mat.append([0, 0, 0, sx, sy, 1, -ey * sx, -ey * sy])
        rhs.append(ey)
    sol = np.linalg.solve(np.array(mat, "float32"),
                          np.array(rhs, "float32"))
    return np.concatenate([sol, [1.0]]).reshape(3, 3).astype("float32")


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """Projective warp mapping startpoints -> endpoints (reference
    transforms/functional.py perspective)."""
    H = _perspective_coeffs(startpoints, endpoints)
    return _inverse_warp(_as_hwc(img), np.linalg.inv(H), fill=fill)


# --------------------------------------------------- transform classes ----
class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1):
        self.n = num_output_channels

    def __call__(self, img):
        return to_grayscale(img, self.n)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.args = (padding, fill, padding_mode)

    def __call__(self, img):
        return pad(img, *self.args)


class ContrastTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        v = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, v)


class SaturationTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        v = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_saturation(img, v)


class HueTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        v = random.uniform(-min(0.5, self.value), min(0.5, self.value))
        return adjust_hue(img, v)


class ColorJitter(BaseTransform):
    """Random brightness/contrast/saturation/hue (reference
    transforms/transforms.py ColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def __call__(self, img):
        if self.brightness:
            img = adjust_brightness(img, random.uniform(
                max(0, 1 - self.brightness), 1 + self.brightness))
        if self.contrast:
            img = adjust_contrast(img, random.uniform(
                max(0, 1 - self.contrast), 1 + self.contrast))
        if self.saturation:
            img = adjust_saturation(img, random.uniform(
                max(0, 1 - self.saturation), 1 + self.saturation))
        if self.hue:
            img = adjust_hue(img, random.uniform(-self.hue, self.hue))
        return img


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, numbers.Number) \
            else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def __call__(self, img):
        import math as _m

        a = _as_hwc(img)
        h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = _m.exp(random.uniform(_m.log(self.ratio[0]),
                                       _m.log(self.ratio[1])))
            cw = int(round(_m.sqrt(target * ar)))
            ch = int(round(_m.sqrt(target / ar)))
            if cw <= w and ch <= h:
                top = random.randint(0, h - ch)
                left = random.randint(0, w - cw)
                patch = a[top:top + ch, left:left + cw]
                return resize(patch, self.size, self.interpolation)
        return resize(center_crop(a, min(h, w)), self.size,
                      self.interpolation)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0):
        self.degrees = (-degrees, degrees) if isinstance(
            degrees, numbers.Number) else tuple(degrees)
        self.args = (interpolation, expand, center, fill)

    def __call__(self, img):
        angle = random.uniform(*self.degrees)
        return rotate(img, angle, *self.args)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None):
        self.degrees = (-degrees, degrees) if isinstance(
            degrees, numbers.Number) else tuple(degrees)
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.fill = fill
        self.center = center

    def __call__(self, img):
        a = _as_hwc(img)
        h, w = a.shape[:2]
        angle = random.uniform(*self.degrees)
        tx = ty = 0
        if self.translate is not None:
            tx = random.uniform(-self.translate[0], self.translate[0]) * w
            ty = random.uniform(-self.translate[1], self.translate[1]) * h
        sc = random.uniform(*self.scale) if self.scale else 1.0
        sh = random.uniform(-self.shear, self.shear) \
            if isinstance(self.shear, numbers.Number) else 0.0
        return affine(a, angle, (tx, ty), sc, (sh, 0.0), fill=self.fill,
                      center=self.center)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0):
        self.prob = prob
        self.scale = distortion_scale

    def __call__(self, img):
        if random.random() > self.prob:
            return img
        a = _as_hwc(img)
        h, w = a.shape[:2]
        dx = int(self.scale * w / 2)
        dy = int(self.scale * h / 2)
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        end = [(random.randint(0, dx), random.randint(0, dy)),
               (w - 1 - random.randint(0, dx), random.randint(0, dy)),
               (w - 1 - random.randint(0, dx), h - 1 - random.randint(0, dy)),
               (random.randint(0, dx), h - 1 - random.randint(0, dy))]
        return perspective(a, start, end)


class RandomErasing(BaseTransform):
    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def __call__(self, img):
        import math as _m

        if random.random() > self.prob:
            return img
        a = _as_hwc(img)
        h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = _m.exp(random.uniform(_m.log(self.ratio[0]),
                                       _m.log(self.ratio[1])))
            eh = int(round(_m.sqrt(target / ar)))
            ew = int(round(_m.sqrt(target * ar)))
            if eh < h and ew < w:
                top = random.randint(0, h - eh)
                left = random.randint(0, w - ew)
                return erase(a, top, left, eh, ew, self.value)
        return a
