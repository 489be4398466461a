"""CLI app smoke tests (tiny sizes, CPU)."""

import glob
import os

import numpy as np



def test_render_cli(tmp_path):
    from clive2.apps.render import main

    out = str(tmp_path / "out")
    ck = str(tmp_path / "ck.npz")
    main([
        "--scene", "empty", "--width", "24", "--height", "16",
        "--samples", "2", "--output-dir", out, "--checkpoint", ck,
        "--unidirectional",
    ])
    pngs = glob.glob(os.path.join(out, "*.png"))
    assert len(pngs) == 2  # main + unidirectional
    assert os.path.exists(ck)

    # resume: continues from sample 2
    main([
        "--scene", "empty", "--width", "24", "--height", "16",
        "--samples", "3", "--output-dir", out, "--checkpoint", ck,
    ])
    ckpt = np.load(ck)
    assert int(ckpt["samples"]) == 3


def test_movie_cli(tmp_path):
    from clive2.apps.movie import main

    out = str(tmp_path)
    main([
        "--scene", "empty", "--width", "24", "--height", "16",
        "--samples", "1", "--movie-frames", "3", "--movie-name", "m",
        "--output-dir", out,
    ])
    frames = sorted(glob.glob(os.path.join(out, "m", "*.png")))
    assert len(frames) == 3
    a, b = (open(f, "rb").read() for f in frames[:2])
    assert a != b  # camera orbits


def test_movie_frame_sharding(tmp_path):
    from clive2.apps.movie import main

    out = str(tmp_path)
    for offset in (0, 1):
        main([
            "--scene", "empty", "--width", "16", "--height", "16",
            "--samples", "1", "--movie-frames", "4", "--movie-name", "s",
            "--output-dir", out, "--frame-stride", "2",
            "--frame-offset", str(offset),
        ])
    frames = sorted(glob.glob(os.path.join(out, "s", "*.png")))
    assert [os.path.basename(f) for f in frames] == [
        f"frame_{i:04d}.png" for i in range(4)
    ]