"""Turntable-animation CLI: orbiting camera, one PNG per frame.

Rebuild of reference src/movie.py with the same flags
(--movie-name/--movie-frames/--start-frame, movie.py:12-20).  Unlike the
reference — which rebuilds the whole scene, BVH, and kernels every frame
(movie.py:31-38) — frames here reuse the jit cache whenever the geometry
pytree shapes match, and frames can be sharded across processes with
--frame-stride/--frame-offset (frames are embarrassingly parallel,
SURVEY §5 "distributed backend").
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

from .render import save_png


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--samples", type=int, default=15)
    parser.add_argument("--width", type=int, default=1280)
    parser.add_argument("--height", type=int, default=720)
    parser.add_argument("--scene", type=str, default="teapots")
    parser.add_argument("--movie-name", type=str, default="test-movie")
    parser.add_argument("--movie-frames", type=int, default=120)
    parser.add_argument("--start-frame", type=int, default=0)
    parser.add_argument("--output-dir", type=str, default="output")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--frame-stride", type=int, default=1,
                        help="render every k-th frame (multi-process sharding)")
    parser.add_argument("--frame-offset", type=int, default=0)
    parser.add_argument("--display", choices=("auto", "on", "off"),
                        default="auto",
                        help="cv2 live window per frame (reference "
                        "movie.py:41-44); auto = on when cv2 + display exist")
    args = parser.parse_args(argv)

    from ..renderer import Renderer
    from ..scene import create_scene_from_preset_with_params, orbit_camera

    movie_dir = os.path.join(args.output_dir, args.movie_name)
    if args.start_frame == 0 and args.frame_offset == 0:
        if os.path.exists(movie_dir):
            shutil.rmtree(movie_dir)
    os.makedirs(movie_dir, exist_ok=True)

    frames = list(range(
        args.start_frame + args.frame_offset, args.movie_frames, args.frame_stride
    ))
    base_scene = None
    from .render import make_display
    show = make_display(args.display)

    for f in frames:
        frame_start = time.time()
        if base_scene is None:
            # geometry + BVH built exactly once; later frames only move the
            # camera (the reference rebuilds scene+BVH+kernels every frame,
            # movie.py:31-38)
            base_scene = create_scene_from_preset_with_params(
                args.scene,
                pixel_width=args.width,
                pixel_height=args.height,
                frame_idx=f,
                total_frames=args.movie_frames,
            )
            scene = base_scene
        else:
            scene = base_scene.with_camera(
                orbit_camera(f, args.movie_frames, args.width, args.height)
            )
        renderer = Renderer(scene, seed=args.seed + f)
        for i in range(args.samples):
            t0 = time.time()
            renderer.run_sample()
            print(f"Sample {i} time: {time.time() - t0:.3f}")
        renderer.block()
        if show is not None:
            show(renderer.image)
        save_png(os.path.join(movie_dir, f"frame_{f:04d}.png"), renderer.image)
        print(f"Frame {f} time: {time.time() - frame_start:.2f}")


if __name__ == "__main__":
    main()
