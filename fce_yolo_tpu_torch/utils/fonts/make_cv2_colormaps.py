"""Build ``cv2_colormaps.npz``, the lookup tables of ``utils/imgproc.py::
apply_color_map``.

Run once, on a machine with OpenCV, from the repository root::

    python -m fce_yolo_tpu_torch.utils.fonts.make_cv2_colormaps

For each of cv2's 22 colormaps (ids 0-21, named as ``imgproc.COLORMAP_NAMES``)
it stores ``cv2.applyColorMap`` of the 256 gray levels: a (256, 3) uint8 BGR
table under the colormap's name. The package never imports this module.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fce_yolo_tpu_torch.utils.imgproc import COLORMAP_NAMES

OUT = Path(__file__).with_name("cv2_colormaps.npz")


def main() -> None:
    import cv2

    levels = np.arange(256, dtype=np.uint8)[:, None]
    tables = {}
    for i, name in enumerate(COLORMAP_NAMES):
        assert getattr(cv2, f"COLORMAP_{name}") == i, name
        tables[name] = cv2.applyColorMap(levels, i)[:, 0, :]
    np.savez_compressed(OUT, **tables)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
