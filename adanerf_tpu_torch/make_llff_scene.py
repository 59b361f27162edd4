"""Write a synthetic forward-facing scene in the raw LLFF layout
(``images/*.png`` and ``poses_bounds.npy``), so that the NDC path
(``convert_llff`` -> the NDC training configs -> evaluate -> viewer) runs
without an LLFF capture.

Counterpart of ``tools/make_llff_scene.py`` (``utils/synthetic.py``), with
its arguments.

  python -m adanerf_tpu_torch.make_llff_scene out_llff -s 240 180 --n-images 24
  python -m adanerf_tpu_torch.convert_llff -dir out_llff -factor 1
"""

from __future__ import annotations

import argparse

from .utils.synthetic import make_llff_scene


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("-s", "--size", type=int, nargs=2, default=(96, 72), metavar=("W", "H"))
    ap.add_argument("--n-images", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    make_llff_scene(a.out, w=a.size[0], h=a.size[1], n_images=a.n_images, seed=a.seed)
    print(f"wrote LLFF scene to {a.out} ({a.size[0]}x{a.size[1]}, {a.n_images} images)")


if __name__ == "__main__":
    main()
