"""Convert a reference viewer sample directory (its trained ONNX models,
``config.ini`` and ``dataset_info.txt``) into the port's export directory:

  python -m adanerf_tpu_torch.convert_reference_onnx <sample_dir> <out_dir>

Counterpart of the JAX package's ``tools/convert_reference_onnx.py``. The
ONNX initializers carry the reference modules' state-dict names, so
``torch_ckpt``'s maps apply after the wire reader
(``utils/onnx_weights.py``). The result renders with
``python -m adanerf_tpu_torch.viewer <out_dir>``.
"""

from __future__ import annotations

import os
import sys
from shutil import copyfile

from .train_state import save_tree
from .utils.onnx_weights import load_onnx_weights
from .utils.torch_ckpt import flat_from_state_dict


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        raise SystemExit("usage: python -m adanerf_tpu_torch.convert_reference_onnx "
                         "<sample_dir> <out_dir>")
    src, dst = argv
    os.makedirs(dst, exist_ok=True)
    for i in range(2):
        path = os.path.join(src, f"model{i}.onnx")
        sd = load_onnx_weights(path)
        out = os.path.join(dst, f"model{i}.weights")
        save_tree(out, flat_from_state_dict(sd, path))
        print(f"model{i}: {len(sd)} tensors -> {out}")
    for name in ("config.ini", "dataset_info.txt"):
        copyfile(os.path.join(src, name), os.path.join(dst, name))
    print(f"export dir ready: {dst}")
    return dst


if __name__ == "__main__":
    main()
