"""Package plumbing: where the compile cache goes, the PNG writer, and
the movie launcher's one-worker-per-card command lines."""

import os
import struct
import sys
import zlib

import numpy as np
import pytest

import clive2
from clive2.apps.render import save_png

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import movie_launcher  # noqa: E402


def test_cache_dir_defers_to_jax_variable():
    assert clive2.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/somewhere"}) is None
    assert clive2.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/x", "JAX_PLATFORMS": "cpu"}) is None


def test_cache_dir_default_is_fixed_checkout_path():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert clive2.compile_cache_dir({}) == want
    assert clive2.compile_cache_dir({"JAX_PLATFORMS": "cuda"}) == want
    assert clive2.compile_cache_dir({}) == clive2.compile_cache_dir({})


def test_cache_dir_cpu_subdirectory_under_default_only():
    d = clive2.compile_cache_dir({"JAX_PLATFORMS": "cpu"})
    assert os.path.dirname(d) == clive2.DEFAULT_CACHE_DIR
    assert os.path.basename(d) == "cpu-" + clive2._cpu_flags_tag()


def _read_png(path):
    """Minimal decoder for the writer's own output (8-bit RGB, filter 0)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, ctype, _, _, _ = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    assert (depth, ctype) == (8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_png_round_trip_bgr_to_rgb(tmp_path):
    bgr = np.random.default_rng(0).integers(0, 256, (7, 5, 3), np.uint8)
    path = tmp_path / "sub" / "img.png"
    save_png(str(path), bgr)
    np.testing.assert_array_equal(_read_png(path), bgr[:, :, ::-1])


def test_launcher_pins_one_card_per_worker():
    cmds = movie_launcher.worker_commands(
        3, 2, 1, ["--", "--scene", "dragon", "--movie-frames", "12"])
    assert [env["CUDA_VISIBLE_DEVICES"] for env, _ in cmds] == ["0", "1", "2"]
    for w, (_, argv) in enumerate(cmds):
        assert argv[1:3] == ["-m", "clive2.apps.movie"]
        assert argv[argv.index("--frame-stride") + 1] == "6"
        assert argv[argv.index("--frame-offset") + 1] == str(3 + w)
        assert "--" not in argv and argv[-4:] == ["--scene", "dragon",
                                                   "--movie-frames", "12"]


def test_launcher_refuses_more_workers_than_cards(monkeypatch, capsys):
    monkeypatch.setattr(movie_launcher, "count_cards", lambda: 2)
    launched = []
    monkeypatch.setattr(movie_launcher.subprocess, "Popen",
                        lambda *a, **k: launched.append(a))
    with pytest.raises(SystemExit) as e:
        movie_launcher.main(["--workers", "3", "--", "--scene", "dragon"])
    assert e.value.code != 0 and not launched
    assert "exceeds the 2 card(s)" in capsys.readouterr().err
