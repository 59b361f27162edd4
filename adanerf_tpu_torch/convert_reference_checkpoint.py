"""Convert reference (torch) AdaNeRF checkpoints into the port's npz
format:

  python -m adanerf_tpu_torch.convert_reference_checkpoint SRC [DST]
  python -m adanerf_tpu_torch.convert_reference_checkpoint SRC_DIR DST_DIR [--suffix 300000]

Counterpart of the JAX package's ``tools/convert_reference_checkpoint.py``.
The reference trainer saves one ``{model_name}_{suffix}.weights`` torch file
per network; they are rewritten as flat-key npz trees under the same file
names, so ``--preTrained`` or a resume can point at the directory.
"""

from __future__ import annotations

import argparse
import os
import sys

from .utils.torch_ckpt import convert_experiment_dir, convert_torch_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help=".weights file or experiment directory")
    ap.add_argument("dst", nargs="?", default=None,
                    help="output file/directory (default: in place / src)")
    ap.add_argument("--suffix", default=None,
                    help="only convert checkpoints with this name suffix")
    args = ap.parse_args(argv)

    if os.path.isdir(args.src):
        done = convert_experiment_dir(args.src, args.dst or args.src, suffix=args.suffix)
        for d in done:
            print(f"converted {d}")
        return done
    out = convert_torch_checkpoint(args.src, args.dst)
    print(f"converted {out}")
    return [out]


if __name__ == "__main__":
    main(sys.argv[1:])
