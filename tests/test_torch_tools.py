"""The port's tools on the CPU, mirroring ``tests/test_tools.py`` where it
applies: ``make_video --frames`` (with imageio and without it), the chunked
render, ``utils.profiling``, the zlib PNG reader and the image loaders
without PIL, and the package's top-level exports.

``dump_hlo``, ``print_lowered`` and ``cost_analysis`` read XLA artefacts
and have no counterpart in the port, so their test has none here.
"""

import struct
import sys
import zlib

import numpy as np
import pytest
import torch

import lomanerf_tpu
import lomanerf_tpu_torch
from lomanerf_tpu_torch import core as tcore
from lomanerf_tpu_torch.train import make_video
from lomanerf_tpu_torch.train.logging_utils import read_png, write_png
from lomanerf_tpu_torch.utils import device_memory_stats, trace


def frames_dir(tmp_path, n=5, size=16):
    """``n`` numbered random RGB PNGs written by ``write_png``, named so
    that a string sort would put 10 before 2."""
    d = tmp_path / "frames"
    imgs = [(np.random.default_rng(i).random((size, size, 3)) * 255).astype(np.uint8)
            for i in range(n)]
    for i, img in enumerate(imgs):
        write_png(str(d / f"{i * 5}.png"), img)
    return d, np.stack(imgs)


def test_make_video_from_frames(tmp_path):
    """With imageio: an mp4, or a gif where it has no ffmpeg backend."""
    pytest.importorskip("imageio")
    d, _ = frames_dir(tmp_path)
    out = tmp_path / "out.mp4"
    wrote = make_video.main(["--frames", str(d), "--out", str(out), "--fps", "5"])
    assert wrote in (str(out), str(tmp_path / "out.gif"))
    assert (tmp_path / wrote).stat().st_size > 0


def test_make_video_without_imageio_writes_numbered_pngs(tmp_path, monkeypatch, capsys):
    """Without imageio the frames, read in numeric order, go to numbered
    PNGs next to ``--out``, and the run says so."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    d, imgs = frames_dir(tmp_path)
    wrote = make_video.main(["--frames", str(d), "--out", str(tmp_path / "out.mp4")])
    assert wrote == str(tmp_path / "out_frames")
    assert "imageio is not installed" in capsys.readouterr().out
    back = make_video.read_frames(wrote)
    np.testing.assert_array_equal(back, imgs)


def test_render_image_chunked():
    """Model-level chunked full-image render (the reference's eval loop):
    every chunk size gives the same pixels."""
    from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel

    cfg = NeRFConfig(num_samples=4, filter_size=8)
    model = NeRFModel(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    K = tcore.normalized_intrinsics(1.1, device="cpu")
    with torch.no_grad():
        img = model.render_image(K, torch.eye(4), img_size=8, chunk=16)
        whole = model.render_image(K, torch.eye(4), img_size=8)
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    torch.testing.assert_close(img, whole, rtol=0, atol=0)


def test_trace_writes_a_chrome_trace_and_cpu_memory_stats_are_empty(tmp_path):
    log_dir = tmp_path / "prof"
    with trace(str(log_dir)) as d:
        assert d == str(log_dir)
        torch.ones(64, 64) @ torch.ones(64, 64)
    text = (log_dir / "trace.json").read_text()
    assert "traceEvents" in text and "aten::" in text
    assert device_memory_stats() == {} and device_memory_stats("cpu") == {}


def encode_png(img, filters):
    """An RGB(A) PNG whose row y uses filter ``filters[y % len]``, encoded
    here from the PNG specification (write_png uses filter 0 only)."""
    h, w, ch = img.shape
    raw, prior = b"", np.zeros(w * ch, np.int64)
    for y in range(h):
        line = img[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(ch, np.int64), line[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int64), prior[:-ch]])
        ft = filters[y % len(filters)]
        if ft == 0:
            pred = np.zeros_like(line)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prior
        elif ft == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, ul))
        raw += bytes([ft]) + ((line - pred) % 256).astype(np.uint8).tobytes()
        prior = line

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2 if ch == 3 else 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_png_reader_round_trips_and_undoes_every_filter(tmp_path, channels):
    img = np.random.default_rng(channels).integers(0, 256, (9, 11, channels), dtype=np.uint8)
    write_png(str(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "w.png")), img)
    (tmp_path / "f.png").write_bytes(encode_png(img, [0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(read_png(str(tmp_path / "f.png")), img)


def test_png_reader_reads_pil_pngs_and_refuses_others(tmp_path):
    from PIL import Image

    yy, xx = np.mgrid[0:37, 0:53]
    img = np.stack([xx * 4, yy * 6, xx + yy, (xx * yy) % 256], -1).astype(np.uint8)
    for mode, arr in (("RGB", img[..., :3]), ("RGBA", img)):
        Image.fromarray(arr, mode).save(tmp_path / f"{mode}.png", optimize=True)
        np.testing.assert_array_equal(read_png(str(tmp_path / f"{mode}.png")), arr)
    Image.fromarray(img[..., 0], "L").save(tmp_path / "grey.png")
    with pytest.raises(ValueError, match="colour type 0"):
        read_png(str(tmp_path / "grey.png"))


def test_image_loaders_without_pil(tmp_path, monkeypatch):
    """Without PIL, ``load_rgb`` (the Blender loader's and ``fit_image``'s)
    reads PNGs through ``read_png``: exact at the file's size; resized
    within a few 8-bit levels of PIL's bicubic resize of an RGB image."""
    from PIL import Image

    from lomanerf_tpu_torch.data.blender import load_rgb
    from lomanerf_tpu_torch.train.fit_image import load_target

    yy, xx = np.mgrid[0:48, 0:48] / 47.0
    rgb = (255 * np.stack([0.5 + 0.5 * np.sin(6 * xx), yy, 0.5 * (xx + yy)], -1)
           ).round().astype(np.uint8)
    path = str(tmp_path / "t.png")
    Image.fromarray(rgb).save(path)
    with_pil = load_rgb(path, 20)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        from PIL import Image  # noqa: F401, F811
    np.testing.assert_array_equal(load_target(path, 48), rgb.astype(np.float32) / 255.0)
    without = load_rgb(path, 20)
    assert without.shape == (20, 20, 3) and without.dtype == np.float32
    assert np.abs(without - with_pil).max() <= 3.0 / 255.0


def test_top_level_exports_the_jax_packages_core_functions():
    """The ten core functions ``lomanerf_tpu`` exports at its top level are
    exported by ``lomanerf_tpu_torch`` too, each the port's own."""
    names = [n for n in dir(lomanerf_tpu)
             if getattr(getattr(lomanerf_tpu, n), "__module__", "").startswith(
                 "lomanerf_tpu.core")]
    assert len(names) == 10
    for name in names:
        fn = getattr(lomanerf_tpu_torch, name)
        assert fn is getattr(tcore, name)
        assert fn.__module__.startswith("lomanerf_tpu_torch.core.")
