"""Config/flag system of the port.

Counterpart of ``adanerf_tpu/config.py``: the same flags and ``.ini``
dialect, parsed with plain ``argparse``:

* ``-c file.ini`` loads options from an ini file. Section headers
  (``[Training]`` etc.) and ``;`` comments are ignored, values of the form
  ``[a, b, c]`` feed ``action='append'`` options one element at a time.
* Command-line options override config-file options.
* ``only_known_args`` mode ignores unknown keys (used when re-parsing the
  config echoed into an experiment's log directory).

Two additions: ``--device`` (``cuda`` by default; the tests pass ``cpu``),
and every on/off flag also takes a ``--no-`` form, so that a command line
can turn off what an ``.ini`` turns on (``--no-performEvaluation``).
"""

from __future__ import annotations

import argparse
import os
import sys


# choices mirror the reference registry enumerations (src/util/config.py)
IN_FEATURES = ["SpherePosDir", "CamPosDir", "RayMarchFromPoses", "RayMarchFromCoarse"]
OUT_FEATURES = ["ClassifiedDepth", "RGBARayMarch", "Raw", "RawSigmoid"]
LOSSES = ["none", "None", "MSE", "LimitedDepthMSE", "MultiDepthLimitedMSE",
          "BCEWithLogitsLoss", "CrossEntropyLoss", "CrossEntropyLossWeighted",
          "MSEPlusWeightAccum", "NeRFWeightMultiplicationLoss"]
SAMPLERS = ["none", "LinearlySpacedZNearZFar", "LinearlySpacedFromDepth",
            "UnitSphereLinearOutsideLog", "LinearlySpacedFromDepthNoDepthRange",
            "LinearlySpacedFromMultiDepth", "FromClassifiedDepth", "FromDepthCells",
            "FromClassifiedDepthAdaptive", "LinearlySpacedZNearZFarNoDepthRange",
            "FromClassifiedDepthAdaptiveNoDepthRange", "FromIterativeSamplePlacement"]
NORMALIZATIONS = ["None", "Centered", "MaxDepth", "MaxDepthCentered", "LogCentered",
                  "InverseDistCentered", "InverseSqrtDistCentered"]
CAM_TYPES = ["CenteredCamera", "RotatingCamera", "TranslatingCamera",
             "PredefinedCamera", "ViewCellForwardCamera"]


def build_parser() -> argparse.ArgumentParser:
    """The full option set of the reference (src/util/config.py:16-193)."""
    p = argparse.ArgumentParser(allow_abbrev=False)
    p.add_argument('-c', '--config', default=None)

    # Data params
    p.add_argument('-data', '--data', required=True, type=str)
    p.add_argument('-log', '--logDir', required=True, type=str)
    p.add_argument('--samplePlacementDir', type=str, default=None)
    p.add_argument('--trainStatsName', default='logs.csv', type=str)
    p.add_argument('--preTrained', default=[], action='append', type=str)
    p.add_argument('--preTrainedSuffix', default="", type=str)
    p.add_argument('--depthTransform', default="linear", type=str,
                   choices=["log", "linear", "none"])
    p.add_argument('-s', '--scale', default=2, type=int)
    p.add_argument('--scaleInterpolation', default="median", type=str,
                   choices=["area", "leaveOut", "median"])

    # Feature params
    p.add_argument('-if', '--inFeatures', default=[], action='append', type=str,
                   choices=IN_FEATURES)
    p.add_argument('-of', '--outFeatures', default=[], action='append', type=str,
                   choices=OUT_FEATURES)
    p.add_argument('-pe', '--posEnc', default=[], action='append', type=str,
                   choices=["none", "nerf"])
    p.add_argument('--posEncArgs', default=[], type=str, action='append')
    p.add_argument('--raySampleInput', default=[], type=int, action='append')

    # Network params
    p.add_argument('-act', '--activation', default=[], type=str, action='append',
                   choices=["relu", "nerf"])
    p.add_argument('-l', '--layers', default=[], type=int, action='append')
    p.add_argument('-lw', '--layerWidth', default=[], type=int, action='append')
    p.add_argument('-sk', '--skips', default=[], type=str, action='append')

    # Training params
    p.add_argument('-d', '--device', default="cuda", type=str,
                   help="torch device: cuda (default), cuda:N, or cpu; a bare "
                        "index N means cuda:N")
    p.add_argument('-e', '--epochs', default=300001, type=int)
    p.add_argument('--batchImages', default=-1, type=int)
    p.add_argument('-smpl', '--samples', default=128, type=int)
    p.add_argument('--lrate', default=0.0001, type=float)
    p.add_argument('--lrate_decay', default=0.1, type=float)
    p.add_argument('--lrate_decay_steps', default=300000, type=int)
    p.add_argument('--losses', default=[], type=str, choices=LOSSES, action='append')
    p.add_argument('--lossAlpha', default=[], type=float, action='append')
    p.add_argument('--lossBeta', default=[], type=float, action='append')
    p.add_argument('--lossWeights', default=[], type=float, action='append')
    p.add_argument('-r', '--randomSeed', default=-1, type=int)
    p.add_argument('--sampleGenerator', default="PreGeneratedRSequenceGenerator", type=str,
                   choices=["PreGeneratedRSequenceGenerator",
                            "PreGeneratedUniformRandomSequenceGenerator"])
    p.add_argument('--storeFullData', default=False, action=argparse.BooleanOptionalAction)
    p.add_argument("--numWorkers", default=8, type=int)
    p.add_argument('-amp', '--amp', default=False, action=argparse.BooleanOptionalAction)

    # PreTraining params
    p.add_argument('--epochsPretrain', default=[], type=int, action='append')
    p.add_argument('--batchImagesPretrain', default=-1, type=int)
    p.add_argument('--samplesPretrain', default=-1, type=int)
    p.add_argument('--epochsLockWeightsBefore', default=[], type=int, action='append')
    p.add_argument('--epochsLockWeightsAfter', default=[], type=int, action='append')

    # Training Output params
    p.add_argument('-Eckpt', '--epochsCheckpoint', default=10000, type=int)
    p.add_argument('-Er', '--epochsRender', default=10000, type=int)
    p.add_argument('-Ev', '--epochsValidate', default=50000, type=int)
    p.add_argument('--epochsVideo', default=-1, type=int)
    p.add_argument('--videoFrames', default=-1, type=int)
    p.add_argument('--inferenceChunkSize', default=65536, type=int)
    p.add_argument("-nV", "--nonVerbose", default=False, action=argparse.BooleanOptionalAction)
    p.add_argument("--dispatchSleepMs", default=0.0, type=float,
                   help="accepted for config compatibility; unused by the port")
    p.add_argument("--verboseEvery", default=100, type=int,
                   help="epochs between progress lines; each costs one "
                        "device-to-host read of the losses")

    # NeRF/Raymarching-params
    p.add_argument("--zNear", default=[], type=float, action='append')
    p.add_argument("--zFar", default=[], type=float, action='append')
    p.add_argument("--numRaymarchSamples", default=[], type=int, action='append')
    p.add_argument("--rayMarchSampler", default=[], type=str, action='append',
                   choices=SAMPLERS)
    p.add_argument("--adaptiveSamplingThreshold", default=-1.0, type=float)
    p.add_argument("--deterministicSampling", default=False, action=argparse.BooleanOptionalAction)
    p.add_argument("--rayMarchSamplingStep", default=[], type=float, action='append')
    p.add_argument("--rayMarchSamplingNoise", default=[], type=float, action='append')
    p.add_argument('--trainWithGTDepth', default=False, action=argparse.BooleanOptionalAction)
    p.add_argument('--useNerfDepthMap', default=False, action=argparse.BooleanOptionalAction)
    p.add_argument('--useNDC', default=False, action=argparse.BooleanOptionalAction)
    p.add_argument("--rayMarchNormalization", default=[], type=str, action='append',
                   choices=NORMALIZATIONS)
    p.add_argument("--rayMarchNormalizationCenter", default=[], type=float, action='append')
    p.add_argument("--perturb", default=False, action=argparse.BooleanOptionalAction)

    # Video camera params
    p.add_argument("--camType", default="PredefinedCamera", type=str, choices=CAM_TYPES)
    p.add_argument("--camCenter", default=[], type=float, action='append')
    p.add_argument("--camRadius", default=4, type=float)
    p.add_argument("--camUpAngle", default=20, type=float)
    p.add_argument("--camRightAngle", default=20, type=float)
    p.add_argument("--movementVector", default=[], type=float, action='append')
    p.add_argument('--camPath', default='cam_path_pan', type=str)

    # Test params
    p.add_argument("--checkPointName", default="opt.weights", type=str)
    p.add_argument("--outputNetworkRaw", default=[], type=str, action='append')
    p.add_argument("--outputVideoName", default="test_video", type=str)

    # Multi Depth params
    p.add_argument("--multiDepthFeatures", default=[], action='append', type=int)
    p.add_argument("--multiDepthWindowSize", default=[], action='append', type=str)
    p.add_argument("--multiDepthIgnoreValue", default=[], action='append', type=float)

    # Evaluation params
    p.add_argument("--performEvaluation", default=False, action=argparse.BooleanOptionalAction)

    p.add_argument("--accumulationMult", default=None, type=str)
    p.add_argument("--lossComponents", default=[], action="append", type=str)
    p.add_argument("--lossComponentBlending", default=[], action="append", type=float)
    p.add_argument("--lossBlendingStart", default=-1, type=int)
    p.add_argument("--lossBlendingDuration", default=-1, type=int)

    # additions of the JAX package (absent in the reference)
    p.add_argument("--meshDevices", default=-1, type=int,
                   help="number of devices for data-parallel training; -1 = all "
                        "(the port trains on one device)")
    p.add_argument("--bf16", default=False, action=argparse.BooleanOptionalAction,
                   help="use bfloat16 matmul operands in the MLPs (fp32 accumulation)")
    p.add_argument("--fusedTrainKernel", default=1, type=int,
                   help="route the shading MLP's train-step forward+backward "
                        "through the hand-written CUDA kernel on a CUDA device "
                        "(needs --bf16)")
    p.add_argument("--checkpointParamsOnly", default=0, type=int,
                   help="periodic checkpoints save model weights only (no "
                        "optimizer state); the final save keeps the full "
                        "state. Resuming from a params-only checkpoint "
                        "restarts Adam moments from zero.")
    p.add_argument("--checkpointGroupMB", default=2.0, type=float,
                   help="accepted for config compatibility; unused by the port")
    return p


_STORE_TRUE = {"storeFullData", "amp", "nonVerbose", "deterministicSampling",
               "trainWithGTDepth", "useNerfDepthMap", "useNDC", "perturb",
               "performEvaluation", "bf16"}


def _ini_to_argv(path: str) -> list:
    """Expand an ini file into an argv list (configargparse ini dialect).

    Handles section headers, ``;``/``#`` comments, scalar values and
    bracketed lists (``key = [a, b]`` -> ``--key a --key b``).
    """
    argv = []
    with open(path, "r") as f:
        for raw in f:
            line = raw.split(';')[0].split('#')[0].strip()
            if not line or line.startswith('['):
                continue
            if '=' not in line:
                continue
            key, val = line.split('=', 1)
            key = key.strip()
            val = val.strip()
            if val.startswith('[') and val.endswith(']'):
                items = [v.strip() for v in val[1:-1].split(',')]
                for item in items:
                    argv += [f"--{key}", item if item != "" else " "]
            elif key in _STORE_TRUE:
                if val.lower() in ("true", "1", "yes"):
                    argv.append(f"--{key}")
            else:
                argv += [f"--{key}", val]
    return argv


def _cli_dests(parser: argparse.ArgumentParser, argv: list) -> set:
    """Destinations explicitly set on the command line (they override ini)."""
    dests = set()
    opt_map = {}
    for action in parser._actions:
        for opt in action.option_strings:
            opt_map[opt] = action.dest
    for tok in argv:
        if tok.startswith('-'):
            opt = tok.split('=', 1)[0]
            if opt in opt_map:
                dests.add(opt_map[opt])
    return dests


class Config:
    """Reference-compatible entry: ``Config.init()`` -> argparse Namespace.

    (reference: src/util/config.py:12-193)
    """
    _parser = None

    @classmethod
    def reset(cls):
        cls._parser = None

    @classmethod
    def init(cls, path=None, only_known_args=False, argv=None):
        parser = build_parser()
        if argv is None:
            argv = sys.argv[1:]
        if path is not None:
            argv = ['-c', path] + [a for a in argv if a not in ('-c', '--config')]

        # locate -c in argv
        cfg_path = None
        cli_rest = list(argv)
        for i, tok in enumerate(argv):
            if tok in ('-c', '--config') and i + 1 < len(argv):
                cfg_path = argv[i + 1]
                cli_rest = argv[:i] + argv[i + 2:]
                break
            if tok.startswith('--config='):
                cfg_path = tok.split('=', 1)[1]
                cli_rest = argv[:i] + argv[i + 1:]
                break

        ini_argv = []
        if cfg_path is not None:
            ini_argv = _ini_to_argv(cfg_path)
            # CLI overrides ini: drop ini tokens whose dest appears on the CLI
            cli_set = _cli_dests(parser, cli_rest)
            filtered = []
            skip_next = False
            for j, tok in enumerate(ini_argv):
                if skip_next:
                    skip_next = False
                    continue
                if tok.startswith('--'):
                    dest = tok[2:]
                    if dest in cli_set:
                        if dest not in _STORE_TRUE:
                            skip_next = True
                        continue
                filtered.append(tok)
            ini_argv = filtered

        full = ini_argv + cli_rest
        if only_known_args:
            args, _unknown = parser.parse_known_args(full)
        else:
            args = parser.parse_args(full)
        args.config = cfg_path
        return args


def write_config_echo(config, log_dir: str):
    """Serialize the effective config to ``<logDir>/config.ini``
    (reference: src/train_data.py:180-195). The echoed file is re-read by
    evaluation and by the real-time benchmark harness, of either package:
    ``device`` is written as the JAX package's ``-d`` takes it, a card's
    index (``cuda:N`` -> N), and left out for the CPU, which has none.
    """
    path = os.path.join(log_dir, "config.ini")
    if os.path.exists(path):
        return
    translation = {39: None}  # strip single quotes like the reference
    with open(path, 'w') as f:
        for key, val in vars(config).items():
            if key == "device":
                name = str(val)
                if name.startswith("cuda"):
                    val = int(name.split(":")[1]) if ":" in name else 0
                elif not name.isdigit():
                    continue
            if val is None:
                continue
            if isinstance(val, list) and len(val) == 0:
                continue
            f.write(f"{key} = {str(val).translate(translation)}\n")
