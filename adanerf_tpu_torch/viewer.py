"""Real-time viewer benchmark of an exported AdaNeRF model on one GPU.

Counterpart of the root ``viewer.py`` with ``--megakernel`` (its production
path): loads an exported model directory (config.ini, dataset_info.txt,
model{0,1}.weights), renders frames along an in-cell orbit or a
``--camPath`` camera path through a hand-written CUDA kernel, prints frame
ms / FPS / samples per pixel every logging interval, and optionally dumps
frames as PNG. ``--megakernel`` picks the kernel: ``v5d`` and ``v5`` run
K1, the compacted renderer (``ops/kernels/megakernel_compact.py``); ``v3``
runs K2, the dense-slot renderer (``ops/kernels/megakernel_dense.py``),
which suits frames whose rays sit at the sample cap. Without
``--megakernel``, an export K1 takes (``megakernel_compact.refusal``, the
predicate its wrapper raises on: adaptive, at most 16 samples, MLPs of
any width and depth, each its own, the nerf encoding of at most 128
input columns, an implemented normalization...)
renders through K1, and any other (a dense run's export, a ``MaxDepth``
normalization...) through the plain renderer,
``RealtimeRenderer.render_frame``, as the JAX viewer renders it without
``--megakernel``; a ``--megakernel`` that the export cannot take is refused,
as in JAX, naming the JAX line that refuses the same. The viewer prints
which path renders and why. ``--dynamic`` is accepted
for the JAX viewer's command lines and changes nothing: the plain path has
no capacity to bucket. ``--mesh N`` shards each frame's rays over N GPUs
(``parallel/render.py``: one kernel a GPU, no collectives); it needs a
frame kernel and refuses more GPUs than there are, as the JAX viewer
refuses ``--mesh`` without ``--megakernel`` and above its device count.

On the card a kernel renders the whole frame and there is no fallback to
the plain path; with ``--device cpu`` each kernel's plain PyTorch version
renders it, ``--batch_size`` rays at a time. The JAX viewer's square-block
ray order (``block_permutation``) is not ported: it exists because its
Pallas kernels gate work per tile of rays, while K1 compacts the live
samples over the whole frame and K2 shades every slot, so neither gains
from spatially coherent tiles.

  python -m adanerf_tpu_torch.viewer demo/trained_mscene_export -s 800 800 -n 10
  python -m adanerf_tpu_torch.viewer demo/trained_mscene_export --megakernel v3 -d frames/
"""

from __future__ import annotations

import argparse
import ast
import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from .data.camera import PredefinedCamera
from .data.png import write_png
from .models.mlp import BaseNetDef, NeRFDef
from .ops.depth_transforms import get_depth_transform
from .ops.kernels.megakernel_compact import MegakernelCompact, refusal as kernel_refusal
from .ops.kernels.megakernel_dense import MegakernelDense
from .ops.raygen import generate_ray_directions
from .parallel.render import ShardedFrame, devices_mesh
from .pipeline.features import SceneStatic
from .realtime import RealtimeRenderer
from .utils.weights import load_export_weights


def parse_kv_file(path):
    """Parse ``key = value`` files (config.ini / dataset_info.txt) where the
    value may be a scalar, a string or a bracketed list."""
    out = {}
    with open(path) as f:
        for raw in f:
            line = raw.split(';')[0].strip()
            if not line or line.startswith('[') or '=' not in line:
                continue
            k, v = line.split('=', 1)
            k, v = k.strip(), v.strip()
            try:
                out[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                if v.startswith('[') and v.endswith(']'):
                    conv = []
                    for it in (x.strip() for x in v[1:-1].split(',')):
                        try:
                            conv.append(ast.literal_eval(it))
                        except (ValueError, SyntaxError):
                            conv.append(it)
                    out[k] = conv
                else:
                    out[k] = v
    return out


def build_renderer_from_export(model_dir, batch_size=65536, dtype_str="bf16",
                               device="cuda"):
    """Plain renderer of an export directory; returns (renderer, scene).
    Net shapes are inferred from the weight files; dtype_str is "bf16" or
    "fp32" (both MLPs), or "oracle32" / "nerf32": that net in fp32, the
    other in bf16 (``precision_study.py``'s bisection; the plain path only,
    K1 and K2 refuse it: ``build_kernel``)."""
    cfg = parse_kv_file(os.path.join(model_dir, "config.ini"))
    info = parse_kv_file(os.path.join(model_dir, "dataset_info.txt"))

    # the literal token `None` in config.ini is the explicit "None"
    # (identity) normalization, not an absent key (which means MaxDepth)
    rmn = cfg.get("rayMarchNormalization")
    if rmn is not None:
        rmn = ["None" if x is None else x for x in rmn]
    config = SimpleNamespace(
        numRaymarchSamples=cfg["numRaymarchSamples"],
        adaptiveSamplingThreshold=float(cfg.get("adaptiveSamplingThreshold", 0.0)),
        posEnc=cfg["posEnc"], posEncArgs=cfg["posEncArgs"],
        rayMarchNormalization=rmn,
        accumulationMult=cfg.get("accumulationMult"),
        useNDC=cfg.get("useNDC") is True,
        rayMarchSampler=cfg.get("rayMarchSampler"))

    depth_range = tuple(float(x) for x in info["depth_range"])
    res = info.get("resolution", [0, 0])
    scene = SceneStatic(
        w=int(res[0]), h=int(res[1]), fov=float(info["fov"]), focal=float(info["focal"]),
        view_cell_center=tuple(float(x) for x in info["view_cell_center"]),
        view_cell_radius=float(np.linalg.norm(
            np.array(info["view_cell_size"], np.float64) / 2.0)),
        depth_range=depth_range, depth_range_warped=depth_range,
        depth_transform=get_depth_transform(cfg.get("depthTransform", "log")),
        depth_max=float(info["max_depth"]))

    args0 = [int(x) for x in config.posEncArgs[0].split('-')]
    path0 = os.path.join(model_dir, "model0.weights")
    path1 = os.path.join(model_dir, "model1.weights")
    with np.load(path0) as w0:
        depth0 = sum(1 for k in w0.files if k.endswith(".w"))
        width0 = int(w0["0.w"].shape[1])
        n_out0 = int(w0[f"{depth0 - 1}.w"].shape[1])
    with np.load(path1) as w1:
        depth1 = sum(1 for k in w1.files if k.startswith("pts.") and k.endswith(".w"))
        width1 = int(w1["pts.0.w"].shape[1])
        in_ch1 = int(w1["pts.0.w"].shape[0])
        skips1 = tuple(i - 1 for i in range(1, depth1)
                       if w1[f"pts.{i}.w"].shape[0] > width1)
        in_views1 = int(w1["views.0.w"].shape[0]) - width1
    oracle = BaseNetDef(depth=depth0, width=width0, n_in=args0[0] * 6 + 3 + 3 + args0[1] * 6,
                        n_out=n_out0, skip="", net_idx=0)
    nerf = NeRFDef(depth=depth1, width=width1, input_ch=in_ch1,
                   input_ch_views=in_views1, n_out=4, skips=skips1 or (4,), net_idx=1)
    load_export_weights(oracle, path0)
    load_export_weights(nerf, path1)
    if dtype_str not in ("bf16", "fp32", "oracle32", "nerf32"):
        raise ValueError(f"dtype_str is 'bf16', 'fp32', 'oracle32' or 'nerf32', got {dtype_str!r}")
    per_net = {"oracle32": dict(oracle_dtype=None), "nerf32": dict(nerf_dtype=None)}
    rt = RealtimeRenderer(oracle.to(device), nerf.to(device), scene, config,
                          batch_size=batch_size,
                          dtype=None if dtype_str == "fp32" else torch.bfloat16, device=device,
                          **per_net.get(dtype_str, {}))
    return rt, scene


def orbit_poses(center, radius, n, phase=0.0):
    """In-view-cell orbit (the interactive camera's role, headless)."""
    poses = []
    for i in range(n):
        a = phase + 2 * np.pi * i / max(n, 1)
        offset = radius * np.array([np.cos(a), 0.15 * np.sin(2 * a), np.sin(a)])
        poses.append(np.asarray(center) + offset)
    return poses


def frame_directions(scene, w, h, device):
    """(w*h, 3) camera-space dirs at render size, keeping the exported fov."""
    focal = 0.5 * w / np.tan(0.5 * scene.fov)
    dirs = generate_ray_directions(w, h, scene.fov, focal).reshape(-1, 3)
    return torch.from_numpy(dirs.astype(np.float32)).to(device)


def build_kernel(rt, variant):
    """The frame kernel of a ``--megakernel`` variant, with the JAX viewer's
    refusals: a non-adaptive model or more than 16 samples for any variant
    (SystemExit), an NDC export for ``v3`` (ValueError); and the kernels'
    own (ValueError: ``megakernel_compact.refusal``, K2's), among them a
    renderer whose two MLPs run at different precisions (``"oracle32"``,
    ``"nerf32"``): the kernels are built for fp32 or bf16 throughout."""
    S = rt.max_samples
    if not (rt.threshold > 0.0 and S <= 16):
        raise SystemExit("--megakernel needs an adaptive model (threshold>0, <=16 samples; "
                         f"got thr={rt.threshold}, S={S})")
    if variant == "v3":
        if rt.use_ndc:
            raise ValueError("only the compacted kernel (--megakernel v5d/v5) implements the "
                             "NDC ray transform; v3 does not")
        return MegakernelDense(rt)
    return MegakernelCompact(rt)


def kernel_frame(kernel, dirs, pose, rot, batch):
    """(rgb (n, 3), counts (n,)) of one frame through a frame kernel: the
    whole frame in one call on the card, ``batch`` rays at a time through
    its plain version on the CPU."""
    if dirs.device.type == "cuda":
        return kernel(dirs, pose, rot)
    outs = [kernel(dirs[s:s + batch], pose, rot) for s in range(0, dirs.shape[0], batch)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def camera_path(cam_path, n_frames):
    """[(position (3,), rotation (3, 3))] of a PredefinedCamera json file,
    at most n_frames of them."""
    transforms = PredefinedCamera.import_camera_path(
        os.path.dirname(cam_path) or ".", os.path.basename(cam_path).replace(".json", ""),
        n_frames)
    return [(t[:3, 3], t[:3, :3]) for t in transforms]


def main(argv=None):
    """Run the viewer; returns a dict of the run's numbers."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("model_dir", type=str)
    p.add_argument("-s", "--size", nargs=2, type=int, default=[800, 800])
    p.add_argument("-bs", "--batch_size", type=int, default=80_000,
                   help="rays per batch of the plain path (--device cpu); the kernel "
                        "renders the whole frame at once")
    p.add_argument("-n", "--frames", type=int, default=100)
    p.add_argument("-d", "--dump_dir", type=str, default=None,
                   help="write each frame as <dump_dir>/<index>.png")
    p.add_argument("--camPath", type=str, default=None,
                   help="camera path json (PredefinedCamera format) instead of the orbit")
    p.add_argument("--logging_interval", type=int, default=10)
    p.add_argument("--fp32", action="store_true", help="fp32 instead of bf16 MLPs")
    p.add_argument("--megakernel", nargs="?", const="v5d", default=None,
                   choices=["v5d", "v5", "v3"],
                   help="v5d and v5: K1, the compacted kernel (the JAX viewer's fixed- and "
                        "dynamic-trip variants differ only on the TPU; K1 takes any live "
                        "count on the device); v3: K2, the dense-slot kernel, which shades "
                        "every slot and suits rays at the sample cap. Not given: K1 where "
                        "K1 takes the export (adaptive, at most 16 samples, the nerf "
                        "encoding of <= 128 columns, ...), else the plain renderer")
    p.add_argument("--dynamic", action="store_true",
                   help="the JAX viewer's in-graph bucketing of its plain path; accepted, "
                        "no effect here")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard each frame's rays over this many GPUs (needs a frame "
                        "kernel); 0 = the whole frame on one device")
    p.add_argument("--device", default="cuda",
                   help="'cuda' renders through the CUDA kernel; 'cpu' through "
                        "its plain PyTorch version")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu for the plain path")
    w, h = args.size
    bs = min(args.batch_size, w * h)
    rt, scene = build_renderer_from_export(args.model_dir, batch_size=bs,
                                           dtype_str="fp32" if args.fp32 else "bf16",
                                           device=device)
    refused = None if args.megakernel is not None else kernel_refusal(rt)
    if refused is None:
        variant = args.megakernel or "v5d"
        kernel = build_kernel(rt, variant)
        route = (f"{'K2' if variant == 'v3' else 'K1'} ({type(kernel).__name__}, "
                 + ("CUDA kernel)" if device.type == "cuda" else "its plain version on the CPU)"))
    else:
        kernel = None
        route = (f"the plain renderer (RealtimeRenderer.render_frame): K1 does not take this "
                 f"export: {refused}")
    print(f"rendering through {route}", flush=True)
    dirs = frame_directions(scene, w, h, device)
    n_pix = dirs.shape[0]
    sharded = None
    if args.mesh:
        if kernel is None:
            raise SystemExit("--mesh needs a frame kernel (the sharded frame runs K1 or K2 on "
                             "each device's slice); this export renders on the plain path")
        try:
            devices = devices_mesh(args.mesh, device.type)
        except ValueError as err:
            raise SystemExit(str(err)) from err
        print(f"rays-sharded rendering over {len(devices)} device(s)", flush=True)
        sharded = ShardedFrame(kernel, devices, dirs)
    if args.camPath:
        cams = camera_path(args.camPath, args.frames)
    else:
        cams = [(pos, np.eye(3, dtype=np.float32)) for pos in orbit_poses(
            scene.view_cell_center, 0.4 * scene.view_cell_radius, args.frames)]

    def render(pos, rot):
        if sharded is not None:
            return sharded(pos, rot)
        if kernel is None:
            return rt.render_frame(pos, rot, dirs)
        return kernel_frame(kernel, dirs, pos, rot, bs)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    render(*cams[0])  # builds the kernel on first use
    sync()
    print(f"engine build (kernel build + warmup): {time.perf_counter() - t0:.1f}s")

    t_start = t_last = time.perf_counter()
    i_last = 0
    for i, (pos, rot) in enumerate(cams):
        frame, counts = render(pos, rot)
        if args.dump_dir or (i + 1) % args.logging_interval == 0:
            spp = float(counts.sum()) / n_pix  # reads back, so the frame is done
            now = time.perf_counter()
            fps = (i + 1 - i_last) / (now - t_last)  # over the frames since the last line
            t_last, i_last = now, i + 1
            print(f"frame {i + 1:5d}: {1e3 / max(fps, 1e-9):7.2f} ms "
                  f"({fps:6.2f} FPS) avg samples/px {spp:.2f}")
            if args.dump_dir:
                os.makedirs(args.dump_dir, exist_ok=True)
                img = frame.clamp(0, 1).reshape(h, w, 3).cpu().numpy()
                write_png(os.path.join(args.dump_dir, f"{i:05d}.png"),
                          (img * 255).astype(np.uint8))
    sync()
    dt = time.perf_counter() - t_start
    print(f"total: {len(cams)} frames in {dt:.2f}s = {len(cams) / dt:.2f} FPS "
          f"({len(cams) * n_pix / dt / 1e6:.2f} Mrays/s)")
    stats = {"frames": len(cams), "n_pix": n_pix, "wall_s": dt, "route": route,
             "samples_per_pixel": float(counts.sum()) / n_pix,
             "last_frame": frame.reshape(h, w, 3)}
    if device.type == "cuda":
        # device time per frame over a second pass: one CUDA event between
        # consecutive frames, read after the pass
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(cams) + 1)]
        events[0].record()
        for (pos, rot), ev in zip(cams, events[1:]):
            render(pos, rot)
            ev.record()
        events[-1].synchronize()
        per = np.array([a.elapsed_time(b) for a, b in zip(events, events[1:])])
        ms = float(per.mean())
        stats.update(device_ms_per_frame=ms, device_ms_median=float(np.median(per)),
                     device_ms_min=float(per.min()), device_ms_max=float(per.max()))
        print(f"device time: {ms:.3f} ms/frame mean, median {np.median(per):.3f}, "
              f"min {per.min():.3f}, max {per.max():.3f} ({n_pix / ms / 1e3:.2f} Mrays/s)")
    return stats


if __name__ == "__main__":
    main()
