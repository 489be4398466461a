"""Still-render CLI: progressive BDPT render of a preset scene.

Rebuild of reference src/render.py with the same flags
(--samples/--width/--height/--save-on-quit/--scene, render.py:13-19) plus
checkpointing flags (the reference has no sample-level resume, SURVEY §5).
The reference's cv2 live preview (render.py:35-37) is kept behind
``--display`` (auto-detected: needs importable cv2 + a display); headless
deployments fall back to the periodic PNG writes of ``--preview-every``.
Output is a timestamped PNG like the reference (render.py:47-50).
"""

from __future__ import annotations

import argparse
import os
import struct
import time
import zlib
from datetime import datetime

import numpy as np


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_png(path: str, bgr_u8: np.ndarray):
    """Write an [H, W, 3] uint8 BGR image (the internal colour order) as
    an 8-bit RGB PNG, with zlib and struct only."""
    rgb = np.ascontiguousarray(np.asarray(bgr_u8, np.uint8)[:, :, ::-1])
    h, w = rgb.shape[:2]
    # every scanline starts with filter type 0 (None)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, w * 3)], axis=1).tobytes()
    png = (b"\x89PNG\r\n\x1a\n"
           + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _png_chunk(b"IDAT", zlib.compress(raw, 6))
           + _png_chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


def make_display(mode: str):
    """Return a show(bgr_u8) callable, or None when display is off.

    Parity with reference src/render.py:35-37 (cv2.imshow each
    sample, BGR frames).  'auto' enables the window only when cv2 imports
    AND a display exists; 'on' demands it (raises otherwise).
    """
    if mode == "off":
        return None
    has_display = bool(os.environ.get("DISPLAY")
                       or os.environ.get("WAYLAND_DISPLAY")
                       or os.name == "nt")
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None or not has_display:
        if mode == "on":
            raise RuntimeError(
                "--display on requires cv2 and a display "
                f"(cv2={'yes' if cv2 else 'no'}, display="
                f"{'yes' if has_display else 'no'})")
        return None

    def show(bgr_u8):
        cv2.imshow("render", bgr_u8)
        cv2.waitKey(1)

    return show


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--samples", type=int, default=15)
    parser.add_argument("--width", type=int, default=1280)
    parser.add_argument("--height", type=int, default=720)
    parser.add_argument("--save-on-quit", action="store_true")
    parser.add_argument("--scene", type=str, default="teapots")
    parser.add_argument("--output-dir", type=str, default="output/default")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--preview-every", type=int, default=0,
                        help="write a preview PNG every N samples (0 = off)")
    parser.add_argument("--display", choices=("auto", "on", "off"),
                        default="auto",
                        help="cv2 live preview window per sample (reference "
                        "render.py:35-37); 'auto' = on when cv2 + a display "
                        "exist, silently off otherwise")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="checkpoint file; resumes if it exists")
    parser.add_argument("--checkpoint-every", type=int, default=0)
    parser.add_argument("--unidirectional", action="store_true",
                        help="also save the plain path-traced image")
    parser.add_argument("--timing", action="store_true")
    parser.add_argument("--chunk-rows", type=int, default=None,
                        help="render in row stripes of this height (default: "
                        "only when the frame does not fit device memory)")
    parser.add_argument("--adaptive-after", type=int, default=0,
                        help="after N uniform warmup samples, sample only "
                        "the highest-variance pixels (0 = always uniform)")
    parser.add_argument("--adaptive-fraction", type=float, default=0.25,
                        help="fraction of pixels per adaptive sample")
    args = parser.parse_args(argv)

    from .. import constants
    constants.TIMED_ENABLED = args.timing

    from ..renderer import Renderer
    from ..scene import create_scene_from_preset

    scene = create_scene_from_preset(
        args.scene, pixel_width=args.width, pixel_height=args.height
    )
    print(f"scene '{args.scene}': {scene.n_triangles} triangles, "
          f"{scene.n_nodes} BVH nodes, built in {scene.build_seconds:.2f}s")

    renderer = Renderer(scene, seed=args.seed, chunk_rows=args.chunk_rows)
    if args.checkpoint and os.path.exists(args.checkpoint):
        renderer.load_checkpoint(args.checkpoint)
        print(f"resumed at sample {renderer.samples} from {args.checkpoint}")

    start = time.time()
    preview_path = os.path.join(args.output_dir, "preview.png")
    show = make_display(args.display)
    try:
        for i in range(renderer.samples, args.samples):
            if args.adaptive_after and i >= args.adaptive_after:
                renderer.run_adaptive_sample(args.adaptive_fraction)
            else:
                renderer.run_sample()
            print(f"Sample {i}/{args.samples} completed")
            if show is not None:
                show(renderer.image)
            if args.preview_every and (i + 1) % args.preview_every == 0:
                save_png(preview_path, renderer.image)
            if (
                args.checkpoint
                and args.checkpoint_every
                and (i + 1) % args.checkpoint_every == 0
            ):
                renderer.save_checkpoint(args.checkpoint)
    except KeyboardInterrupt:
        if not args.save_on_quit:
            raise
        print("interrupted; saving current image")

    renderer.block()
    print(f"Rendering took {time.time() - start:.2f} seconds")

    stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    out_path = os.path.join(args.output_dir, f"{stamp}.png")
    save_png(out_path, renderer.image)
    print(f"wrote {out_path}")
    if args.unidirectional:
        uni_path = os.path.join(args.output_dir, f"{stamp}_unidirectional.png")
        save_png(uni_path, renderer.unidirectional_image)
        print(f"wrote {uni_path}")
    if args.checkpoint:
        renderer.save_checkpoint(args.checkpoint)


if __name__ == "__main__":
    main()
