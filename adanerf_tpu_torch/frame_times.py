"""Times of the port's kernels on one NVIDIA card: the bf16 frame
renderers K1 and K2, and the train step's K3.

  python adanerf_tpu_torch/frame_times.py [--root DIR] [--only frames|k3]

Frames: renders ``demo/trained_mscene_export`` at 800x800 from
chip_smoke.py's pose through K1 (``MegakernelCompact``) and K2
(``MegakernelDense``) in bf16, at the export's threshold, at 0.01 and at
1e-4, and prints for each the times of the ``stages`` ladder
(``frame_ms``: the whole frame, the front, front + shade), the timing
chip_smoke.py's phases 7, 11 and 13 use too. K3: the export's NeRF through
``NerfTrainKernel`` at the dense step's 524,288 rows (seeded inputs in the
encoding's range): the forward and the backward as the train step calls
them (the autograd function, packing included; the median of ROUNDS means
of REPS calls), and the dense step itself (``train.main`` on
``configs/dense_training.ini`` and ``demo/mscene``, bf16, the NeRF
unlocked: the mean and median of K3_STEPS steps after K3_WARMUP).
``--root`` imports the port from another checkout (its
``adanerf_tpu_torch``, built into its own ``_build``), so two versions can
be timed in turns on one card: run it for each, in the order A, B, B, A.
The card's clocks, power and processes (``card_state``) are printed before
and after. The last line is one JSON object with every number. Exits
non-zero where there is no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    # run as a script, this file's directory leads sys.path: drop it, so that
    # the port's subpackages (config, data, utils) shadow no other module
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") !=
                   os.path.dirname(os.path.abspath(__file__))]

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROUNDS, REPS = 5, 4  # ladder rounds; launches per timed mean
K3_ROWS = 2 * 2048 * 128  # the dense step's shading rows
K3_WARMUP, K3_STEPS = 3, 10


def time_ms(fn, reps):
    """Mean ms of `reps` calls of fn on the current stream (CUDA events),
    after one warm-up call."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def frame_ms(k, dirs, pose, rot):
    """{"ms", "front_ms", "front_shade_ms"} of a render kernel's stage
    ladder (3: the whole frame, 1: the front, 2: front + shade): for each,
    the median over ROUNDS rounds, the three interleaved in each, of the
    mean of REPS launches."""
    times = {1: [], 2: [], 3: []}
    for _ in range(ROUNDS):
        for st in times:
            times[st].append(time_ms(lambda: k(dirs, pose, rot, stages=st), REPS))
    med = {st: float(np.median(v)) for st, v in times.items()}
    return {"ms": med[3], "front_ms": med[1], "front_shade_ms": med[2]}


def _smi(*args):
    """nvidia-smi's csv answer, or None where it gives none."""
    try:
        r = subprocess.run(["nvidia-smi", *args, "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except OSError:
        return None
    return r.stdout.strip() if r.returncode == 0 else None


def card_state():
    """One line from nvidia-smi: the SM clock and its maximum, the memory
    clock, power draw and limit, temperature, the active clock event
    (throttle) reasons, and the compute processes on the card."""
    fields = ["clocks.sm", "clocks.max.sm", "clocks.mem", "power.draw", "power.limit",
              "temperature.gpu"]
    state = None
    for reasons in ("clocks_event_reasons.active", "clocks_throttle_reasons.active", None):
        state = _smi("--query-gpu=" + ",".join(fields + ([reasons] if reasons else [])))
        if state is not None:
            break
    if state is None:
        return "nvidia-smi read nothing"
    vals = [v.strip() for v in state.splitlines()[0].split(",")]
    line = (f"SM {vals[0]} of {vals[1]}, memory {vals[2]}, {vals[3]} of {vals[4]}, "
            f"{vals[5]} C, clock event reasons "
            f"{vals[6] if len(vals) > 6 else 'not read'}")
    apps = _smi("--query-compute-apps=pid,used_memory")
    apps = [a for a in (apps or "").splitlines() if a.strip()]
    return f"{line}; compute processes {len(apps)}: {'; '.join(apps) or 'none listed'}"


def k3_times(dev, export: str) -> dict:
    """K3's forward, backward and dense step times (ms), through the
    entry points the train step uses."""
    import tempfile
    from adanerf_tpu_torch import train
    from adanerf_tpu_torch.models.mlp import NeRFDef
    from adanerf_tpu_torch.ops.kernels.nerf_train import NerfTrainKernel
    from adanerf_tpu_torch.utils.weights import load_export_weights
    nerf = load_export_weights(NeRFDef(), os.path.join(export, "model1.weights")).to(dev)
    k3 = NerfTrainKernel(nerf)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (K3_ROWS, 90)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((K3_ROWS, 4)).astype(np.float32)).to(dev) / (4 * K3_ROWS)
    leaves = list(nerf.parameters())
    xr = x.clone().requires_grad_(True)
    out = k3(xr)
    fwd, bwd = [], []
    for _ in range(ROUNDS):
        with torch.no_grad():
            fwd.append(time_ms(lambda: k3(x), REPS))
        bwd.append(time_ms(lambda: torch.autograd.grad(out, [xr] + leaves, g, retain_graph=True),
                           REPS))
    del out, xr, x, g
    torch.cuda.empty_cache()
    steps = K3_WARMUP + K3_STEPS
    with tempfile.TemporaryDirectory(prefix="frame_times_logs_") as log_dir:
        stats = train.main([
            "-c", os.path.join(HERE, "configs", "dense_training.ini"),
            "-data", os.path.join(HERE, "demo", "mscene"), "-log", log_dir, "--bf16",
            "--epochs", str(1 + steps), "--randomSeed", "0",
            # one value per network (an append option): neither is locked
            "--epochsLockWeightsBefore", "-1", "--epochsLockWeightsBefore", "-1",
            "--epochsRender", "1000000", "--epochsValidate", "1000000",
            "--epochsCheckpoint", "1000000", "--no-performEvaluation", "--verboseEvery", "1000"])
    step_ms = [float(v) for v in stats["step_ms"][K3_WARMUP:]]
    return {"rows": K3_ROWS, "forward_ms": float(np.median(fwd)), "backward_ms": float(np.median(bwd)),
            "forward_rounds": fwd, "backward_rounds": bwd, "step_ms_mean": float(np.mean(step_ms)),
            "step_ms_median": float(np.median(step_ms)), "steps": step_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose adanerf_tpu_torch to time")
    ap.add_argument("--only", choices=("frames", "k3"), help="time only these kernels")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)  # import the port from `root`
    if not torch.cuda.is_available():
        print("frame_times: no CUDA device", file=sys.stderr)
        return 2
    from adanerf_tpu_torch import viewer
    from adanerf_tpu_torch.ops.kernels.megakernel_compact import MegakernelCompact
    from adanerf_tpu_torch.ops.kernels.megakernel_dense import MegakernelDense

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{card}; port from {root}", flush=True)
    print(f"card before: {card_state()}", flush=True)
    dev = torch.device("cuda")
    export = os.path.join(HERE, "demo", "trained_mscene_export")
    rt, scene = viewer.build_renderer_from_export(export, dtype_str="bf16", device=dev)
    pose = viewer.orbit_poses(scene.view_cell_center, 0.4 * scene.view_cell_radius, 8)[1]
    rot = np.eye(3, dtype=np.float32)
    dirs = viewer.frame_directions(scene, 800, 800, dev)
    out = {"card": card, "root": root, "rounds": ROUNDS, "reps": REPS, "times": {}}
    for thr in (rt.threshold, 0.01, 1e-4) if args.only != "k3" else ():
        rt.threshold = thr
        for name, cls in (("K1", MegakernelCompact), ("K2", MegakernelDense)):
            k = cls(rt)
            _, counts = k(dirs, pose, rot)
            rec = dict(frame_ms(k, dirs, pose, rot), samples_per_px=float(counts.float().mean()))
            out["times"][f"{name} {thr}"] = rec
            print(f"{name} threshold {thr}: {rec['ms']:.3f} ms/frame (front {rec['front_ms']:.3f}, "
                  f"front+shade {rec['front_shade_ms']:.3f}), samples/px "
                  f"{rec['samples_per_px']:.4f}", flush=True)
    if args.only != "frames":
        out["k3"] = k3_times(dev, export)
        k = out["k3"]
        print(f"K3 at {k['rows']} rows: forward {k['forward_ms']:.3f} ms, backward "
              f"{k['backward_ms']:.3f} ms; dense step {k['step_ms_mean']:.3f} ms (mean of "
              f"{len(k['steps'])}, median {k['step_ms_median']:.3f})", flush=True)
    print(f"card after: {card_state()}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
