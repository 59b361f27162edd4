"""Export a trained run for the real-time viewers:

  python -m adanerf_tpu_torch.export -c <config.ini> -data <scene> -log <dir> \\
      [--checkPointName opt.weights] [--device cpu]

Counterpart of ``adanerf_tpu/export.py`` and the JAX package's root
``export.py``. Into ``<experiment>/exported_model/`` it writes:

* ``model{i}.weights``: each net's parameters, the npz files the port's
  and the JAX package's viewers read;
* ``model{i}.onnx``: the same weights as the ONNX graphs the reference's
  TensorRT viewer reads (``utils/onnx_export.py``);
* ``dataset_info.txt``: the scene constants the viewers parse;
* ``pos_enc.txt``: each net's positional-encoding frequencies;
* ``config.ini``: a copy of the run's echoed config.

The text files and the ONNX files hold the same bytes as the JAX
package's export of the same weights. The JAX export also serializes its
oracle stage as an XLA executable (``stage0_oracle.xla``), best-effort; no
program of either package reads that file, and an XLA executable is not
something the port can produce, so the port writes none and says so.

The run is loaded on ``--device`` (``cuda`` by default; a missing card
raises), its newest checkpoint or the one ``--checkPointName`` names.
"""

from __future__ import annotations

import os
import sys
from shutil import copyfile

import numpy as np

from .train_state import save_tree
from .utils.onnx_export import write_model_onnx
from .utils.weights import to_flat


def write_pos_enc(n_freqs, f):
    """The frequency bands 2^0 .. 2^(n-1), one per line."""
    bands = 2.0 ** np.linspace(0.0, n_freqs - 1, n_freqs)
    for frq in bands:
        f.write(str(np.float32(frq)) + "\n")


def write_dataset_info(ts, out_dir):
    """dataset_info.txt with the fields the viewers parse."""
    info = ts.dataset_info
    with open(os.path.join(out_dir, "dataset_info.txt"), "w") as f:
        f.write("view_cell_center = " + str(info.view.view_cell_center) + "\n")
        f.write("view_cell_size = " + str(info.view.view_cell_size) + "\n")
        f.write("depth_range = " + str(info.depth_range_warped) + "\n")
        f.write("fov = " + str(info.view.fov) + "\n")
        f.write("focal = " + str(info.view.focal) + "\n")
        f.write("camera_scale = " + str(info.view.camera_scale) + "\n")
        f.write("max_depth = " + str(info.depth_max) + "\n")
        # the NDC ray transform depends on the resolution, so an NDC export
        # renders at the trained W/H
        f.write("resolution = [" + str(info.w) + ", " + str(info.h) + "]\n")


def export_artifacts(ts, out_dir=None):
    """Write the export directory of a loaded ``TrainState``; returns it."""
    out_dir = out_dir or ts.config_file.logDir
    os.makedirs(out_dir, exist_ok=True)

    write_dataset_info(ts, out_dir)
    for i, m in enumerate(ts.models):
        flat = to_flat(m)
        save_tree(os.path.join(out_dir, f"model{i}.weights"), flat)
        write_model_onnx(os.path.join(out_dir, f"model{i}.onnx"), m, flat)

    cfg_src = os.path.join(ts.logDir, "config.ini")
    if os.path.exists(cfg_src):
        copyfile(cfg_src, os.path.join(out_dir, "config.ini"))

    with open(os.path.join(out_dir, "pos_enc.txt"), "w") as f:
        for i in range(len(ts.models)):
            args = ts.config_file.posEncArgs[i].split('-')
            f.write(f"# net {i}\n")
            if args[0] != "none":
                write_pos_enc(int(args[0]), f)

    print("AOT export skipped: stage0_oracle.xla is an XLA executable, which the "
          "PyTorch port does not produce (no viewer reads it)")
    print(f"export complete: {out_dir}")
    return out_dir


def main(argv=None):
    """Load the run the arguments name and export it to
    ``<experiment>/exported_model``; returns that directory."""
    from .config import Config
    from .train_state import TrainState

    config = Config.init(only_known_args=True, argv=argv)
    ts = TrainState()
    ts.initialize(config, training=False)
    if config.checkPointName:
        ts.load_specific_weights(config.checkPointName.replace(".weights", ""))
    else:
        ts.load_latest_weights()
    return export_artifacts(ts, os.path.join(ts.logDir, "exported_model"))


if __name__ == "__main__":
    main(sys.argv[1:])
