"""The port's vision transforms and FakeData (paddle_tpu_torch/vision)
against the JAX package's: every transform, class and function, on a
seeded uint8 HWC image (and a float one), with Python's `random` and
numpy's global stream seeded alike before each call, bitwise; FakeData's
images and labels bitwise, and its samples through a transform."""
import random

import numpy as np
import pytest

from paddle_tpu.vision import datasets as jdatasets
from paddle_tpu.vision import transforms as JT

from paddle_tpu_torch.vision import datasets as tdatasets
from paddle_tpu_torch.vision import transforms as TT


def _image(dtype="uint8", seed=0, hw=(20, 24)):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (*hw, 3)).astype(np.uint8)
    return img if dtype == "uint8" else img.astype(np.float32) / 255.0


CASES = {
    "to_tensor": lambda T: T.ToTensor(),
    "to_tensor_hwc": lambda T: T.ToTensor("HWC"),
    "normalize": lambda T: T.Compose([T.ToTensor(),
                                      T.Normalize([0.5] * 3, [0.25] * 3)]),
    "normalize_hwc": lambda T: T.Normalize([10.0, 20.0, 30.0], [2.0] * 3,
                                           data_format="HWC"),
    "resize": lambda T: T.Resize(11),
    "resize_hw": lambda T: T.Resize((7, 30)),
    "center_crop": lambda T: T.CenterCrop(9),
    "random_crop": lambda T: T.RandomCrop(16),
    "random_crop_pad": lambda T: T.RandomCrop((18, 20), padding=4),
    "hflip": lambda T: T.RandomHorizontalFlip(0.5),
    "hflip_always": lambda T: T.RandomHorizontalFlip(1.0),
    "vflip": lambda T: T.RandomVerticalFlip(0.5),
    "transpose": lambda T: T.Transpose(),
    "brightness": lambda T: T.BrightnessTransform(0.4),
    "grayscale": lambda T: T.Grayscale(3),
    "pad": lambda T: T.Pad(3),
    "pad_edge": lambda T: T.Pad((1, 2), padding_mode="edge"),
    "pad_4": lambda T: T.Pad((1, 2, 3, 4), fill=7),
    "pad_reflect": lambda T: T.Pad(2, padding_mode="reflect"),
    "pad_symmetric": lambda T: T.Pad(2, padding_mode="symmetric"),
    "contrast": lambda T: T.ContrastTransform(0.5),
    "saturation": lambda T: T.SaturationTransform(0.5),
    "hue": lambda T: T.HueTransform(0.3),
    "color_jitter": lambda T: T.ColorJitter(0.3, 0.3, 0.3, 0.1),
    "random_resized_crop": lambda T: T.RandomResizedCrop(12),
    "random_resized_crop_hard": lambda T: T.RandomResizedCrop(
        (8, 10), scale=(0.99, 1.0), ratio=(4.0, 5.0)),
    "random_rotation": lambda T: T.RandomRotation(30),
    "random_rotation_expand": lambda T: T.RandomRotation((10, 40),
                                                         expand=True),
    "random_affine": lambda T: T.RandomAffine(20, translate=(0.1, 0.2),
                                              scale=(0.8, 1.2), shear=10),
    "random_perspective": lambda T: T.RandomPerspective(0.9, 0.4),
    "random_erasing": lambda T: T.RandomErasing(0.9, value=3),
    "cifar_train": lambda T: T.Compose([
        T.RandomCrop(16, padding=4), T.RandomHorizontalFlip(), T.ToTensor(),
        T.Normalize([0.5] * 3, [0.5] * 3)]),
}

FUNCS = {
    "to_tensor": lambda T, a: T.to_tensor(a),
    "normalize": lambda T, a: T.normalize(a.astype("float32"), [1, 2, 3],
                                          [4, 5, 6], "HWC"),
    "resize": lambda T, a: T.resize(a, (9, 13)),
    "hflip": lambda T, a: T.hflip(a),
    "vflip": lambda T, a: T.vflip(a),
    "crop": lambda T, a: T.crop(a, 2, 3, 7, 9),
    "center_crop": lambda T, a: T.center_crop(a, (6, 8)),
    "pad": lambda T, a: T.pad(a, 2, fill=9),
    "erase": lambda T, a: T.erase(a, 1, 2, 4, 5, 0),
    "to_grayscale": lambda T, a: T.to_grayscale(a),
    "adjust_brightness": lambda T, a: T.adjust_brightness(a, 1.3),
    "adjust_contrast": lambda T, a: T.adjust_contrast(a, 0.7),
    "adjust_saturation": lambda T, a: T.adjust_saturation(a, 1.6),
    "adjust_hue": lambda T, a: T.adjust_hue(a, -0.2),
    "affine": lambda T, a: T.affine(a, 15.0, (2, -1), 0.9, (5.0, 3.0)),
    "rotate": lambda T, a: T.rotate(a, 33.0),
    "rotate_expand": lambda T, a: T.rotate(a, 33.0, expand=True),
    "perspective": lambda T, a: T.perspective(
        a, [(0, 0), (23, 0), (23, 19), (0, 19)],
        [(2, 1), (21, 3), (20, 18), (1, 17)]),
}


def _run(make, img, seed):
    random.seed(seed)
    np.random.seed(seed)
    return make(img)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("name", CASES)
def test_transform_is_bitwise_the_reference(name, dtype):
    img = _image(dtype)
    for seed in (0, 1, 2):
        got = _run(CASES[name](TT), img, seed)
        want = _run(CASES[name](JT), img, seed)
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("name", FUNCS)
def test_function_is_bitwise_the_reference(name, dtype):
    img = _image(dtype, seed=4)
    got = np.asarray(FUNCS[name](TT, img))
    want = np.asarray(FUNCS[name](JT, img))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_hue_factor_out_of_range_refused():
    with pytest.raises(ValueError):
        TT.adjust_hue(_image(), 0.7)


@pytest.mark.parametrize("kw", [{}, {"num_samples": 37, "seed": 5},
                                {"image_shape": (1, 8, 6),
                                 "num_classes": 3}])
def test_fakedata_is_bitwise_the_reference(kw):
    got, want = tdatasets.FakeData(**kw), jdatasets.FakeData(**kw)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.dtype == want.labels.dtype == np.int64
    assert len(got) == len(want)


def test_fakedata_samples_through_a_transform():
    tf = CASES["cifar_train"]
    got = tdatasets.FakeData(16, transform=tf(TT))
    want = jdatasets.FakeData(16, transform=tf(JT))
    for i in range(16):
        random.seed(i)
        g = got[i]
        random.seed(i)
        w = want[i]
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1] == w[1]
    assert got[0][0].shape == (3, 16, 16) and got[0][0].dtype == np.float32
