"""PNG frames -> GIF/MP4 export (counterpart of rvo3d_tpu/render/gif.py).

Capability of the reference's create_gif.py + env_plot.create_animate
(reference: train/fig_save/create_gif.py:4-24, env_plot.py:357-414).
imageio and cv2 are optional: without them these return None."""

from __future__ import annotations

import os
from typing import List, Optional


def frames_to_gif(frame_paths: List[str], out_path: str,
                  fps: int = 10) -> Optional[str]:
    try:
        import imageio.v2 as imageio
    except ImportError:
        try:
            import imageio
        except ImportError:
            return None
    images = [imageio.imread(p) for p in frame_paths]
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    imageio.mimsave(out_path, images, duration=1.0 / fps)
    return out_path


def frames_to_mp4(frame_paths: List[str], out_path: str,
                  fps: int = 10) -> Optional[str]:
    """MP4 export (reference: env_plot.create_animate, env_plot.py:357-414,
    which drives matplotlib.animation + ffmpeg). OpenCV's bundled mp4v
    codec writes the container directly, with no ffmpeg."""
    try:
        import cv2
    except ImportError:
        return None
    if not frame_paths:
        return None
    first = cv2.imread(frame_paths[0])
    if first is None:
        return None
    h, w = first.shape[:2]
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
    if not writer.isOpened():
        return None
    try:
        for p in frame_paths:
            img = cv2.imread(p)
            if img is None:
                continue
            if img.shape[:2] != (h, w):
                img = cv2.resize(img, (w, h))
            writer.write(img)
    finally:
        writer.release()
    return out_path
