"""The port's CLI and PNG reading vs the JAX package.

``python -m dod_raytracer_tpu_torch.cli`` on the CPU (``--cpu``) as
``tests/test_cli_io.py`` drives the JAX CLI; its PNG read back by the
port's ``io.read_png`` and equal to the port's own render.  ``read_png``
must decode what Pillow decodes (the JAX package's ``read_png``) on files
Pillow writes in each mode and on files encoded here with each of the
five row filters, and refuse what it does not read.  A last test greps
the port and ``chip_smoke.py`` for imports of JAX, Pillow or the JAX
package.
"""

import os
import re
import struct
import zlib

import numpy as np
import pytest
import torch

import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu import io as jio
from dod_raytracer_tpu_torch import cli as tcli
from dod_raytracer_tpu_torch import io as tio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cli_end_to_end_on_the_cpu(tmp_path, capsys):
    """tests/test_cli_io.py:31-45 with --cpu; the PNG equals quantize_u8 of
    the port's render_image for the same config, and --profile writes a
    trace that names the three phases."""
    ini = tmp_path / "config.ini"
    ini.write_text("Width: 40\nHeight: 24\n")
    out = tmp_path / "out.png"
    rc = tcli.main(["--config", str(ini), "--output", str(out), "--mesh", "none", "--depth", "3", "--seed", "1",
                    "--cpu", "--profile", str(tmp_path / "trace")])
    assert rc == 0
    img = tio.read_png(str(out))
    assert img.shape == (24, 40, 3) and img.dtype == np.uint8
    assert img.max() > 10
    assert "rendered 40x24" in capsys.readouterr().out
    cfg = T.Config.load(str(ini), use_kdtree=True, recursion_depth=3)
    scene = T.default_scene(seed=1, cfg=cfg, mesh=None).build(cfg, device="cpu")
    np.testing.assert_array_equal(img, T.quantize_u8(T.render_image(scene, cfg, device="cpu")))
    trace = (tmp_path / "trace" / "trace.json").read_text()
    for name in ("scene_build", "render", "png_write"):
        assert f'"{name}"' in trace


def test_cli_without_a_gpu_exits_nonzero(tmp_path, monkeypatch, capsys):
    """No --cpu and no CUDA device: a message and a non-zero exit, and no
    render on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out.png"
    assert tcli.main(["--output", str(out), "--mesh", "none", "--width", "8", "--height", "4"]) != 0
    assert "--cpu" in capsys.readouterr().err
    assert not out.exists()


def _pil_image(mode):
    from PIL import Image

    yy, xx = np.mgrid[0:29, 0:41]
    rgb = np.stack([(xx * 6) % 256, (yy * 9) % 256, (xx * yy) % 256], -1).astype(np.uint8)
    img = Image.fromarray(rgb, "RGB")
    if mode == "P":
        return img.quantize(50)
    if mode in ("RGBA", "LA"):
        img = img.convert(mode)
        alpha = Image.fromarray(((xx + yy) * 4 % 256).astype(np.uint8), "L")
        img.putalpha(alpha)
        return img
    return img.convert(mode)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_read_png_matches_pillow(tmp_path, mode):
    path = str(tmp_path / f"{mode}.png")
    _pil_image(mode).save(path)
    got = tio.read_png(path)
    ref = jio.read_png(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (29, 41, 3)
    np.testing.assert_array_equal(got, ref)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _encode(img, color, filter_type, depth=8, interlace=0, palette=None):
    """A PNG of ``img`` (H, W, C) uint8, every row under ``filter_type``,
    the IDAT split in two chunks."""
    h, w, c = img.shape
    raw = bytearray()
    prev = bytes(w * c)
    for y in range(h):
        line = img[y].tobytes()
        out = bytearray(len(line))
        for i, x in enumerate(line):
            a = line[i - c] if i >= c else 0
            b = prev[i]
            cc = prev[i - c] if i >= c else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, cc))[filter_type]
            out[i] = (x - pred) & 0xFF
        raw += bytes([filter_type]) + out
        prev = line
    z = zlib.compress(bytes(raw))
    chunk = lambda kind, data: (struct.pack(">I", len(data)) + kind + data
                                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    parts = [chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))]
    if palette is not None:
        parts.append(chunk(b"PLTE", palette.tobytes()))
    parts += [chunk(b"IDAT", z[:len(z) // 2]), chunk(b"IDAT", z[len(z) // 2:]), chunk(b"IEND", b"")]
    return b"\x89PNG\r\n\x1a\n" + b"".join(parts)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_read_png_each_filter(tmp_path, filter_type):
    """Files whose every row takes one filter, in colour types 2 (RGB), 6
    (RGBA: 4 bytes a pixel) and 3 (palette), against Pillow's decode."""
    rng = np.random.default_rng(filter_type)
    rgb = rng.integers(0, 256, (13, 17, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (13, 17, 4), dtype=np.uint8)
    palette = rng.integers(0, 256, (7, 3), dtype=np.uint8)
    index = rng.integers(0, 7, (13, 17, 1), dtype=np.uint8)
    for name, data, want in (("rgb", _encode(rgb, 2, filter_type), rgb),
                             ("rgba", _encode(rgba, 6, filter_type), rgba[..., :3]),
                             ("p", _encode(index, 3, filter_type, palette=palette), palette[index[..., 0]])):
        path = str(tmp_path / f"{name}.png")
        with open(path, "wb") as f:
            f.write(data)
        got = tio.read_png(path)
        np.testing.assert_array_equal(got, jio.read_png(path))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["16-bit", "interlaced", "truncated"])
def test_read_png_refuses(tmp_path, case):
    img = np.random.default_rng(0).integers(0, 256, (8, 9, 3), dtype=np.uint8)
    if case == "16-bit":
        data, reason = _encode(img.repeat(2, axis=2), 2, 0, depth=16), "bit depth 16"
    elif case == "interlaced":
        data, reason = _encode(img, 2, 0, interlace=1), "interlaced"
    else:
        data, reason = _encode(img, 2, 0)[:-40], "cut short|damaged"
    path = tmp_path / f"{case}.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"{re.escape(str(path))}: .*({reason})"):
        tio.read_png(str(path))


def test_write_then_read_png(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (16, 24, 3), dtype=np.uint8)
    tio.write_png(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(tio.read_png(str(tmp_path / "x.png")), img)


def test_port_imports_no_jax_pillow_or_jax_package():
    """No module of the port and no line of chip_smoke.py imports jax,
    PIL or dod_raytracer_tpu (the reference package)."""
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|PIL|dod_raytracer_tpu)(?![\w])", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "dod_raytracer_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert not offenders, offenders
