"""Write a synthetic DONeRF-format scene (coloured spheres in a view cell)
so that the train -> test -> evaluate -> export -> viewer loop runs
without the DONeRF dataset: ``dataset_info.json``,
``transforms_{train,val,test}.json`` and each split's images, with
``--depth`` also ``*_depth.npz`` ground-truth depth.

Counterpart of ``tools/make_synthetic_scene.py`` (``utils/synthetic.py``),
with its arguments.

  python -m adanerf_tpu_torch.make_synthetic_scene out_scene -s 128 128 --n-train 16 --depth
  python -m adanerf_tpu_torch.train -c configs/dense_training.ini -data out_scene -log logs/demo
"""

from __future__ import annotations

import argparse

from .utils.synthetic import make_scene


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="output scene directory")
    ap.add_argument("-s", "--size", type=int, nargs=2, default=(64, 64), metavar=("W", "H"))
    ap.add_argument("--n-train", type=int, default=8)
    ap.add_argument("--n-val", type=int, default=2)
    ap.add_argument("--n-test", type=int, default=2)
    ap.add_argument("--depth", action="store_true",
                    help="write ground-truth *_depth.npz (for depth-supervised oracle losses)")
    ap.add_argument("--objects", choices=["sphere", "multi", "translucent"], default="sphere",
                    help="'multi': layered spheres in a wide view cell (parallax forces 2-3 "
                         "oracle samples/px); 'translucent': glass shells in an enclosing "
                         "room, every ray crossing several semi-transparent surfaces")
    ap.add_argument("--cell-frac", type=float, default=0.2,
                    help="pose jitter as a fraction of the view cell size")
    a = ap.parse_args(argv)
    make_scene(a.out, w=a.size[0], h=a.size[1], n_train=a.n_train, n_val=a.n_val,
               n_test=a.n_test, with_depth=a.depth, objects=a.objects, cell_frac=a.cell_frac)
    print(f"wrote synthetic scene to {a.out} ({a.size[0]}x{a.size[1]}, "
          f"{a.n_train}/{a.n_val}/{a.n_test} train/val/test, depth={a.depth}, "
          f"objects={a.objects})")


if __name__ == "__main__":
    main()
