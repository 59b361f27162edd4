"""Offline render of a trained run's train, val and test splits:

  python -m adanerf_tpu_torch.test -c <config.ini> -data <scene> -log <dir> \\
      [--checkPointName opt.weights] [--device cpu]

Counterpart of the JAX package's root ``test.py``: resume the run's
newest checkpoint, then load the one named by ``--checkPointName`` where
it exists, and render every image of the three splits into
``<experiment>/test_images/{train,val,test}/`` through
``render.render_all_imgs``. The device is CUDA unless ``--device cpu``
is given; a missing card raises.
"""

from __future__ import annotations

import sys

from .config import Config
from .render import render_all_imgs
from .train_state import TrainState


def main(argv=None):
    config = Config.init(only_known_args=True, argv=argv)
    ts = TrainState()
    ts.initialize(config)

    ts.load_latest_weights()
    if config.checkPointName:
        ts.load_specific_weights(config.checkPointName.replace(".weights", ""))

    return {name: render_all_imgs(ts, "test_images/", dataset_name=name)
            for name in ("train", "val", "test")}


if __name__ == "__main__":
    main(sys.argv[1:])
