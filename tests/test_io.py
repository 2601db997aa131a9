"""Round-trip tests for the dependency-free image codecs."""
import numpy as np
import pytest

from hobbyraytracer_tpu.io import hdr, images


@pytest.fixture
def rgb(tmp_path):
    rs = np.random.RandomState(0)
    return rs.randint(0, 256, (13, 17, 3), np.uint8)


def test_png_roundtrip(tmp_path, rgb):
    p = str(tmp_path / "x.png")
    images.write_png(p, rgb)
    np.testing.assert_array_equal(images.read_png(p), rgb)


def test_tga_roundtrip(tmp_path, rgb):
    p = str(tmp_path / "x.tga")
    images.write_tga(p, rgb)
    np.testing.assert_array_equal(images.read_tga(p), rgb)


def test_bmp_roundtrip(tmp_path, rgb):
    p = str(tmp_path / "x.bmp")
    images.write_bmp(p, rgb)
    np.testing.assert_array_equal(images.read_bmp(p), rgb)


def test_reads_reference_golden_png():
    # decode a checked-in full-size render (artifacts/)
    import os
    img = images.read_image(os.path.join(
        os.path.dirname(__file__), "..", "artifacts", "big_shiny_full.png"))
    assert img.ndim == 3 and img.shape[2] in (3, 4)
    assert img.shape[0] > 100 and img.shape[1] > 100


def test_hdr_roundtrip(tmp_path):
    rs = np.random.RandomState(1)
    img = (rs.rand(9, 33, 3) * 10.0).astype(np.float32)
    p = str(tmp_path / "x.hdr")
    hdr.write_hdr(p, img)
    back = hdr.read_hdr(p)
    assert back.shape == img.shape
    # RGBE shares one exponent across RGB: per-pixel precision is bounded by
    # the max channel / 256, not by each component's own magnitude.
    tol = img.max(axis=-1, keepdims=True) / 256.0 + 1e-4
    assert np.all(np.abs(back - img) <= tol)


# ---------------------------------------------------------------- JPEG decode

def _jpeg_bytes(img, **save_kw):
    import io as _io

    from PIL import Image
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **save_kw)
    return buf.getvalue()


@pytest.fixture
def smooth_rgb():
    # low-frequency content so the lossy round-trip tolerance is tight
    from PIL import Image
    rs = np.random.RandomState(2)
    base = rs.randint(0, 256, (4, 6, 3), np.uint8)
    return np.asarray(Image.fromarray(base).resize((97, 53),
                                                   Image.BILINEAR))


@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
def test_jpeg_native_decode_matches_pillow(tmp_path, smooth_rgb,
                                           subsampling):
    """The pure-python baseline decoder agrees with libjpeg within the
    chroma-upsampling difference (ours is nearest, libjpeg's is fancy)."""
    import io as _io

    from PIL import Image

    from hobbyraytracer_tpu.io import jpeg as jpeg_mod
    data = _jpeg_bytes(smooth_rgb, quality=90, subsampling=subsampling)
    ours = jpeg_mod.decode_jpeg(data)
    theirs = np.asarray(Image.open(_io.BytesIO(data)).convert("RGB"))
    assert ours.shape == theirs.shape
    diff = np.abs(ours.astype(int) - theirs.astype(int))
    assert diff.mean() < 3.0
    assert diff.max() <= (4 if subsampling == 0 else 24)


def test_jpeg_grayscale_and_restart_markers(tmp_path, smooth_rgb):
    import io as _io

    from PIL import Image

    from hobbyraytracer_tpu.io import jpeg as jpeg_mod
    g = smooth_rgb[:, :, 0]
    data = _jpeg_bytes(g, quality=85)
    ours = jpeg_mod.decode_jpeg(data)
    theirs = np.asarray(Image.open(_io.BytesIO(data)).convert("RGB"))
    assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 2

    # restart intervals reset the DC predictors mid-scan (DRI/RSTn)
    data = _jpeg_bytes(smooth_rgb, quality=90, subsampling=0,
                       restart_marker_blocks=2)
    ours = jpeg_mod.decode_jpeg(data)
    theirs = np.asarray(Image.open(_io.BytesIO(data)).convert("RGB"))
    assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 4


def test_jpeg_via_read_image_and_progressive_fallback(tmp_path, smooth_rgb):
    """read_image dispatches .jpg to the native decoder; progressive
    streams raise there and fall back to Pillow inside read_jpg."""
    p = str(tmp_path / "x.jpg")
    with open(p, "wb") as f:
        f.write(_jpeg_bytes(smooth_rgb, quality=92, subsampling=0))
    img = images.read_image(p)
    assert img.shape == smooth_rgb.shape
    assert np.abs(img.astype(int) - smooth_rgb.astype(int)).mean() < 6.0

    from hobbyraytracer_tpu.io import jpeg as jpeg_mod
    prog = _jpeg_bytes(smooth_rgb, quality=90, progressive=True)
    with pytest.raises(ValueError):
        jpeg_mod.decode_jpeg(prog)
    pp = str(tmp_path / "p.jpg")
    with open(pp, "wb") as f:
        f.write(prog)
    img2 = images.read_image(pp)  # Pillow fallback path
    assert img2.shape == smooth_rgb.shape


# ----------------------------------------- stb decode-matrix long tail

def test_pnm_decode_binary_and_ascii(tmp_path, rgb):
    """PPM/PGM binary via the Pillow oracle; ascii P3 handwritten."""
    import io as _io

    from PIL import Image

    from hobbyraytracer_tpu.io import extra_formats as X
    buf = _io.BytesIO()
    Image.fromarray(rgb).save(buf, "PPM")
    np.testing.assert_array_equal(X.decode_pnm(buf.getvalue()), rgb)

    g = rgb[:, :, 0]
    buf = _io.BytesIO()
    Image.fromarray(g).save(buf, "PPM")   # PIL picks PGM for mode L
    np.testing.assert_array_equal(X.decode_pnm(buf.getvalue()),
                                  np.repeat(g[:, :, None], 3, 2))

    asc = b"P3\n# comment\n2 2\n255\n255 0 0  0 255 0\n0 0 255  1 2 3\n"
    out = X.decode_pnm(asc)
    np.testing.assert_array_equal(
        out, np.array([[[255, 0, 0], [0, 255, 0]],
                       [[0, 0, 255], [1, 2, 3]]], np.uint8))


@pytest.mark.parametrize("interlace", [False, True])
def test_gif_decode_matches_pillow(tmp_path, rgb, interlace):
    import io as _io

    from PIL import Image

    from hobbyraytracer_tpu.io import extra_formats as X
    buf = _io.BytesIO()
    Image.fromarray(rgb).save(buf, "GIF", interlace=interlace)
    ours = X.decode_gif(buf.getvalue())
    theirs = np.asarray(Image.open(buf).convert("RGB"))
    np.testing.assert_array_equal(ours, theirs)


def test_psd_decode_raw_and_rle(tmp_path, rgb):
    """Synthesized PSD composites (Pillow cannot write PSD): planar RAW
    and PackBits-RLE, matching stb's stbi__psd_load subset."""
    import struct

    from hobbyraytracer_tpu.io import extra_formats as X
    h, w = rgb.shape[:2]
    head = (b"8BPS" + struct.pack(">H", 1) + b"\0" * 6 +
            struct.pack(">HIIHH", 3, h, w, 8, 3) +
            struct.pack(">I", 0) * 3)
    raw = head + struct.pack(">H", 0) + b"".join(
        rgb[:, :, c].tobytes() for c in range(3))
    np.testing.assert_array_equal(X.decode_psd(raw), rgb)

    def packbits(row):
        out = bytearray()
        i = 0
        n = len(row)
        while i < n:
            run = 1
            while i + run < n and row[i + run] == row[i] and run < 127:
                run += 1
            if run >= 2:
                out += bytes([257 - run, row[i]])
                i += run
            else:
                j = i + 1
                while (j < n and (j + 1 >= n or row[j + 1] != row[j])
                       and j - i < 127):
                    j += 1
                out += bytes([j - i - 1]) + bytes(row[i:j])
                i = j
        return bytes(out)

    rows = [packbits(rgb[:, :, c][y].tobytes())
            for c in range(3) for y in range(h)]
    counts = b"".join(struct.pack(">H", len(r)) for r in rows)
    rle = head + struct.pack(">H", 1) + counts + b"".join(rows)
    np.testing.assert_array_equal(X.decode_psd(rle), rgb)


def test_read_image_dispatches_extra_formats(tmp_path, rgb):
    from PIL import Image
    p = str(tmp_path / "x.ppm")
    Image.fromarray(rgb).save(p)
    np.testing.assert_array_equal(images.read_image(p), rgb)
    p = str(tmp_path / "x.gif")
    Image.fromarray(rgb).save(p)
    assert images.read_image(p).shape == rgb.shape
