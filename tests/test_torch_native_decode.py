"""The port's native decode library (`data.native_loader`, built from the
port's own csrc/vct_data.cc) against PIL and cv2, and the datasets'
decode_backend "native" against "pil".

Held as the JAX package's own native tests hold its library: JPEG and PNG
decode byte-exact with PIL at the native size, "bilinear" within 1 of
cv2.INTER_LINEAR (rounding), "pil" within 1 LSB of PIL's bicubic (PIL's
int16 fixed point), PNG colour modes as PIL's convert("RGB"), JPEG and PNG
mixed in one batch, corrupt buffers raising. The JAX package's loader is
not imported here: it builds native/libvctdata.so, a file the port never
writes (checked below).
"""
import io
import os

import numpy as np
import pytest
from PIL import Image

from vision_conglomerate_torch.data import native_loader
from vision_conglomerate_torch.data.detection import DetectionDataset
from vision_conglomerate_torch.data.native_loader import (
    NativeImageDecoder, decode_file, native_available)
from vision_conglomerate_torch.data.segmentation import SegmentationDataset

from tests.test_torch_seg_data import write_polygon_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LIB = os.path.join(REPO, "native", "libvctdata.so")


def _stat(path):
    return (os.stat(path).st_mtime_ns, os.stat(path).st_size) if os.path.exists(path) else None


@pytest.fixture(scope="module")
def decoder():
    before = _stat(JAX_LIB)
    assert native_available(), native_loader._build_error
    assert _stat(JAX_LIB) == before
    return NativeImageDecoder(n_threads=2)


def _encode(arr, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def jpeg_bytes():
    rng = np.random.default_rng(0)
    return _encode((rng.uniform(size=(48, 64, 3)) * 255).astype(np.uint8), "JPEG", quality=90)


@pytest.fixture(scope="module")
def png_bytes():
    rng = np.random.default_rng(1)
    return _encode((rng.uniform(size=(40, 56, 3)) * 255).astype(np.uint8), "PNG")


def _pil(data):
    return Image.open(io.BytesIO(data)).convert("RGB")


def test_library_builds_into_the_package(tmp_path, monkeypatch):
    """A fresh build goes to the given build dir under its hashed name (a
    temporary name renamed into place, under the lock file), and nothing
    is written to the JAX package's native/."""
    before = _stat(JAX_LIB)
    monkeypatch.setattr(native_loader, "BUILD_DIR", str(tmp_path))
    out = native_loader.library_path()
    assert os.path.dirname(out) == str(tmp_path)
    assert os.path.basename(out).startswith("libvctdata-") and out.endswith(".so")
    native_loader._build(out)
    assert sorted(os.listdir(tmp_path)) == sorted([os.path.basename(out), "libvctdata.lock"])
    native_loader._build(out)  # built: a second call leaves it as it is
    assert _stat(JAX_LIB) == before
    assert native_loader.library_path().startswith(str(tmp_path))


@pytest.mark.parametrize("fmt", ["jpeg", "png"])
def test_decode_matches_pil_exactly(decoder, jpeg_bytes, png_bytes, fmt):
    data = jpeg_bytes if fmt == "jpeg" else png_bytes
    ref = np.asarray(_pil(data))
    assert decoder.probe(data) == (ref.shape[1], ref.shape[0])
    np.testing.assert_array_equal(decoder.decode_resize(data, (ref.shape[1], ref.shape[0])), ref)


def test_bilinear_matches_cv2(decoder, jpeg_bytes):
    cv2 = pytest.importorskip("cv2")
    full = np.asarray(_pil(jpeg_bytes))
    for wh in ((32, 24), (100, 70)):
        ours = decoder.decode_resize(jpeg_bytes, wh, resize="bilinear")
        ref = cv2.resize(full, wh, interpolation=cv2.INTER_LINEAR)
        assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("wh", [(32, 24), (64, 64), (90, 50)])
def test_pil_mode_within_one_lsb_of_pil_bicubic(decoder, jpeg_bytes, png_bytes, wh):
    for data in (jpeg_bytes, png_bytes):
        ours = decoder.decode_resize(data, wh, resize="pil")
        ref = np.asarray(_pil(data).resize(wh, Image.BICUBIC))
        assert ours.shape == ref.shape
        assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("mode", ["RGBA", "L", "P", "I;16"])
def test_png_color_modes_match_pil(decoder, mode):
    """Alpha dropped, gray and palette expanded, as PIL's convert("RGB");
    16-bit gray is scaled to 8 bits by libpng, where PIL clips, so only its
    shape is held."""
    rng = np.random.default_rng(2)
    if mode == "RGBA":
        img = Image.fromarray((rng.uniform(size=(24, 32, 4)) * 255).astype(np.uint8), "RGBA")
    elif mode == "L":
        img = Image.fromarray((rng.uniform(size=(24, 32)) * 255).astype(np.uint8), "L")
    elif mode == "P":
        img = Image.fromarray((rng.uniform(size=(24, 32, 3)) * 255).astype(np.uint8)).convert(
            "P", palette=Image.ADAPTIVE)
    else:
        img = Image.fromarray((rng.uniform(size=(24, 32)) * 65535).astype(np.uint16), "I;16")
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    data = buf.getvalue()
    ours = decoder.decode_resize(data, (32, 24))
    ref = np.asarray(_pil(data))
    assert ours.shape == ref.shape
    if mode != "I;16":
        np.testing.assert_array_equal(ours, ref)


def test_batch_mixes_jpeg_and_png(decoder, jpeg_bytes, png_bytes):
    out = np.zeros((4, 32, 32, 3), np.uint8)
    got = decoder.decode_resize_batch([jpeg_bytes, png_bytes, jpeg_bytes, png_bytes], 32,
                                      resize="pil", out=out)
    assert got is out
    for i, data in enumerate((jpeg_bytes, png_bytes)):
        np.testing.assert_array_equal(out[i], decoder.decode_resize(data, 32, resize="pil"))
    np.testing.assert_array_equal(out[0], out[2])
    assert not np.array_equal(out[0], out[1])


def test_corrupt_buffers_raise(decoder, jpeg_bytes, png_bytes):
    with pytest.raises(ValueError):
        decoder.decode_resize(b"not an image", (8, 8))
    with pytest.raises(ValueError):
        decoder.decode_resize(jpeg_bytes[:200], (8, 8))
    with pytest.raises(ValueError):
        decoder.probe(png_bytes[:8] + b"\x00" * 24)
    # one bad item: the batch completes, its slot is zeroed, then it raises
    out = np.full((3, 8, 8, 3), 7, np.uint8)
    with pytest.raises(ValueError, match="1/3"):
        decoder.decode_resize_batch([jpeg_bytes, b"junk", png_bytes], (8, 8), out=out)
    assert out[1].max() == 0 and out[0].max() > 0
    with pytest.raises(ValueError, match="uint8"):
        decoder.decode_resize_batch([jpeg_bytes], (8, 8), out=np.zeros((1, 8, 8, 3), np.float32))


def test_decode_file(decoder, tmp_path, png_bytes):
    path = tmp_path / "a.png"
    path.write_bytes(png_bytes)
    np.testing.assert_array_equal(decode_file(str(path), (20, 10), resize="pil"),
                                  decoder.decode_resize(png_bytes, (20, 10), resize="pil"))


def test_unbuildable_library_raises(monkeypatch):
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_build_error", "g++ not found")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        NativeImageDecoder()
    assert not native_available()


def _write_detection_dataset(root, n, size, ext):
    rng = np.random.default_rng(3)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        img = (rng.uniform(size=(size, size + 16, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"img_{i}.{ext}"))
        with open(os.path.join(root, f"img_{i}.txt"), "w") as f:
            f.write(f"{i % 3} 0.5 0.5 0.3 0.2\n")


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_detection_dataset_native_matches_pil(decoder, tmp_path, ext):
    root = str(tmp_path / "det")
    _write_detection_dataset(root, n=3, size=96, ext=ext)
    ds_pil, ds_nat = (DetectionDataset(root, img_ext=ext, img_wh=(64, 48), max_labels=8,
                                       decode_backend=b) for b in ("pil", "native"))
    for i in range(3):
        (a, la), (b, lb) = ds_pil[i], ds_nat[i]
        assert a.shape == b.shape == (48, 64, 3) and a.dtype == b.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        np.testing.assert_array_equal(la, lb)


def test_unknown_backend_raises(tmp_path):
    with pytest.raises(ValueError, match="decode_backend"):
        DetectionDataset(str(tmp_path), decode_backend="turbo")


def test_segmentation_dataset_native_matches_pil(decoder, tmp_path):
    root = str(tmp_path / "seg")
    write_polygon_dataset(root)
    ds_pil, ds_nat = (SegmentationDataset(root, img_wh=(64, 48), max_labels=8,
                                          mask_store_wh=(16, 12), decode_backend=b)
                      for b in ("pil", "native"))
    for i in range(len(ds_pil)):
        (a, la, ma), (b, lb, mb) = ds_pil[i], ds_nat[i]
        assert a.shape == b.shape and np.abs(a.astype(int) - b.astype(int)).max() <= 1
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(ma, mb)
