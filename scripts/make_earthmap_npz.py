"""Decode assets/earthmap.jpg into assets/earthmap.npz (uint8 [H, W, 3]).

The renderer loads the .npz with NumPy alone, so the earth scenes need no
image library at run time.  Rerun after replacing the JPEG:

    python scripts/make_earthmap_npz.py
"""

import os

import numpy as np
from PIL import Image

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")


def main() -> None:
    img = np.asarray(Image.open(os.path.join(ASSETS, "earthmap.jpg"))
                     .convert("RGB"), np.uint8)
    out = os.path.join(ASSETS, "earthmap.npz")
    np.savez_compressed(out, img=img)
    print(f"{out}: {img.shape} uint8")


if __name__ == "__main__":
    main()
