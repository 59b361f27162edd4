"""Training state: models, optimizer state, losses and feature sets of the
cascade, the train step, weight locking and checkpoints.

Counterpart of ``adanerf_tpu/train_state.py``. The JAX step is one pure
jitted function; here the step runs eagerly and updates the modules'
parameters and the Adam state in place. The shading MLP's forward and
backward go through the K3 kernel (``ops/kernels/nerf_train.py``) when the
device is CUDA, ``--bf16`` is on and ``--fusedTrainKernel`` is 1, the
conditions under which the JAX package takes its Pallas kernel on a TPU.

Checkpoints are npz files with the JAX package's names and keys
(``{net name}_{suffix}.weights`` / ``.optimizer``), written atomically, so
either package resumes from the other's files.

``initialize`` loads the train and validation splits (``training=True``)
and the test split at the full ``w*h`` rays per image, all on the host;
``inference`` runs the plain cascade for rendering, validation and
evaluation, and ``load_specific_weights`` picks a named checkpoint (the
best-validation ``_opt`` one by default). ``make_pretrain_step`` trains one
net alone on ground truth (GT pretraining, ``epochsPretrain``): the
earlier stages' outputs are replaced by their targets, and the loss acts
on the net's raw output through its plain forward, as in JAX.

On a rank of the data-parallel step (``parallel/mesh.py``) the batch
assembly gathers the rank's slice of every image's rays (``rays``), the
step draws its jitter over the whole batch and keeps that slice
(``ray_shard``), and only the writing rank (``writes``) creates the log
directory and its config echo.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

import numpy as np
import torch

from .config import write_config_echo
from .data.dataset import DatasetInfo, ViewCellDataset, load_dataset_split
from .data.sampling import get_sequence_generator
from .ops.draws import RaySlice
from .models.mlp import NeRFDef, get_model, init_params
from .pipeline.cascade import run_cascade
from .pipeline.features import ClassifiedDepth, get_feature_sets
from .pipeline.keys import FSK, DatasetKeys
from .pipeline.losses import get_loss_by_name
from .utils.helper import experiment_name
from .utils.weights import adam_from_flat, adam_to_flat, load_flat, to_flat

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.scale_by_adam's defaults


# ---------------------------------------------------------------------------
# checkpoint IO: npz files with the JAX package's naming scheme
# ---------------------------------------------------------------------------

def save_tree(path: str, flat: Dict[str, np.ndarray]):
    """Write {dotted-key: array} to ``path`` as npz, atomically (a tmp file
    and ``os.replace``), so a killed save never leaves a truncated file."""
    tmp = path + ".tmp"
    np.savez(tmp, **flat)
    os.replace(tmp + ".npz", path)  # np.savez appends .npz


def load_tree(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def read_best_loss(path: str):
    """The loss an ``opt.txt``-style file records (the first decimal number
    on its first line), or None where there is no file or no number."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        m = re.search(r"\d+\.\d+", f.readline())
    return float(m.group(0)) if m else None


def parse_device(name: str) -> torch.device:
    """``--device``: cuda, cuda:N, a bare index N, or cpu."""
    return torch.device(f"cuda:{name}" if str(name).isdigit() else name)


def resolve_device(name: str) -> torch.device:
    """``parse_device``; a CUDA device that is not there raises."""
    dev = parse_device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return dev


class AdamState:
    """``optax.scale_by_adam``'s state for one module: the step count and
    the first and second moments, keyed like the module's state_dict."""

    def __init__(self, module: torch.nn.Module):
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in module.state_dict().items()}
        self.nu = {k: torch.zeros_like(v) for k, v in module.state_dict().items()}


def adam_update(module: torch.nn.Module, state: AdamState, grads: Dict[str, torch.Tensor],
                lr: float):
    """One step of ``optax.scale_by_adam`` followed by ``-lr * u``, in place:
    mu = (1-b1) g + b1 mu; nu = (1-b2) g^2 + b2 nu; p += -lr * mu_hat /
    (sqrt(nu_hat) + eps) with the bias corrections 1 - b^count in fp32."""
    count = state.count + 1
    c = torch.tensor(count, dtype=torch.float32)
    corr1 = (1.0 - torch.tensor(ADAM_B1, dtype=torch.float32) ** c).item()
    corr2 = (1.0 - torch.tensor(ADAM_B2, dtype=torch.float32) ** c).item()
    params = dict(module.named_parameters())
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            mu = (1.0 - ADAM_B1) * g + ADAM_B1 * state.mu[k]
            nu = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu[k]
            u = (mu / corr1) / (torch.sqrt(nu / corr2) + ADAM_EPS)
            p.add_(u * -lr)
            state.mu[k], state.nu[k] = mu, nu
    state.count = count


class TrainState:
    """Owns the models, feature sets, losses and optimizer states of the
    cascade."""

    def __init__(self):
        self.f_in, self.f_out = [], []
        self.models: List[torch.nn.Module] = []
        self.opt_states: List[AdamState] = []
        self.losses, self.loss_weights = [], []
        self.config_file = None
        self.epoch0 = 0
        self.epochs = 300000
        self.logDir = ""
        self.experiment_name = None
        self.dataset_info = None
        self.scene = None
        self.train_dataset = None
        self.valid_dataset = None
        self.test_dataset = None
        self.best_valid_loss = None
        self.best_valid_loss_pretrain = []
        self.pixel_idx_sequence_gen = None
        self.h = self.w = -1
        self.device = torch.device("cpu")
        self.generator = None
        self.ray_shard = None  # (rank, world) on a rank of the data-parallel step

    # -- construction -------------------------------------------------------

    def initialize(self, config, load_data=True, log_path=None, training=True, writes=True):
        """Models, losses, optimizer states and the splits of ``config``;
        ``writes`` False (a rank other than 0) leaves the disk alone."""
        self.config_file = config
        self.device = resolve_device(config.device)
        seed = config.randomSeed if config.randomSeed != -1 else 0
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        for name in ("rayMarchSamplingNoise", "zNear", "zFar"):
            if getattr(config, name) is None:
                setattr(config, name, [])

        self.dataset_info = DatasetInfo(config)
        self.scene = self.dataset_info.scene_static()
        self.h, self.w = self.dataset_info.h, self.dataset_info.w
        self.f_in, self.f_out = get_feature_sets(config, self.scene)

        self.models, self.losses, self.loss_weights = [], [], []
        for i in range(len(self.f_in)):
            self.models.append(get_model(config, self.f_in[i].n_feat, self.f_out[i].n_feat, i))
            self.losses.append(get_loss_by_name(config.losses[i], config, i))
            self.loss_weights.append(config.lossWeights[i])
            for name, default in (("rayMarchSamplingNoise", 0.0), ("zNear", 0.001),
                                  ("zFar", 1.0)):
                if len(getattr(config, name)) <= i:
                    getattr(config, name).append(default)
            if hasattr(self.losses[i], "requires_alpha_beta"):
                if len(config.lossAlpha) <= i:
                    config.lossAlpha.append(1.0)
                if len(config.lossBeta) <= i:
                    config.lossBeta.append(0.0)

        init_params(self.models, seed)
        self.models = [m.to(self.device) for m in self.models]
        self.opt_states = [AdamState(m) for m in self.models]

        self.experiment_name = experiment_name(config, self.f_in, self.f_out, self.models)
        dataset_name = os.path.basename(os.path.normpath(config.data)) + "/"
        self.logDir = log_path if log_path is not None else \
            os.path.join(config.logDir, dataset_name, self.experiment_name) + "/"
        config.logDir = self.logDir
        if writes:
            os.makedirs(self.logDir, exist_ok=True)
        self.epochs = config.epochs

        # the best validation losses of an earlier run in this directory:
        # the joint run's, and each pretraining pass's
        self.best_valid_loss = read_best_loss(os.path.join(self.logDir, "opt.txt"))
        pretrain = [read_best_loss(os.path.join(self.logDir, f"opt_{i}.txt"))
                    for i in range(len(self.models))]
        self.best_valid_loss_pretrain = [v for v in pretrain if v is not None]
        if writes:
            write_config_echo(config, self.logDir)

        if load_data:
            self.pixel_idx_sequence_gen = get_sequence_generator(config.sampleGenerator, dims=2)
            if training:
                self.train_dataset = load_dataset_split(config, self.dataset_info, "train",
                                                        config.samples)
                self.valid_dataset = load_dataset_split(config, self.dataset_info, "val",
                                                        config.samples)
            self.test_dataset = load_dataset_split(config, self.dataset_info, "test",
                                                   self.w * self.h)

    # -- weight locking -----------------------------------------------------

    def _lock_bounds(self, net_idx: int):
        c = self.config_file
        e_bef = c.epochsLockWeightsBefore[net_idx] \
            if c.epochsLockWeightsBefore and len(c.epochsLockWeightsBefore) > net_idx else -1
        e_aft = c.epochsLockWeightsAfter[net_idx] \
            if c.epochsLockWeightsAfter and len(c.epochsLockWeightsAfter) > net_idx else -1
        return e_bef, e_aft

    def ever_unlocked(self, net_idx: int) -> bool:
        """Is net_idx trainable at any epoch of the schedule? A net locked
        for the whole run never has its loss evaluated."""
        e_bef, e_aft = self._lock_bounds(net_idx)
        last = int(self.config_file.epochs)
        if e_bef == -1 and e_aft == -1:
            return True
        if e_bef == -1:                      # locked for epoch > e_aft
            return e_aft >= 1
        if e_aft == -1:                      # locked for epoch < e_bef
            return e_bef <= last
        return e_aft >= 1 or e_bef <= last   # locked strictly in between

    def weights_locked(self, epoch: int, net_idx: int) -> bool:
        e_bef, e_aft = self._lock_bounds(net_idx)
        if e_bef == -1 and e_aft != -1:
            return epoch > e_aft
        if e_bef != -1 and e_aft == -1:
            return epoch < e_bef
        if e_bef != -1 and e_aft != -1:
            return e_bef > epoch > e_aft
        return False

    # -- the train step -----------------------------------------------------

    def train_apply_fns(self):
        """Per-net apply overrides: on a CUDA device with --bf16 and
        --fusedTrainKernel 1, every NeRF (the port's always has view
        directions) whose width is a multiple of 128 runs through K3 (the JAX
        package's conditions, with the TPU in place of CUDA). A NeRF that K3 does not
        take yet raises ValueError rather than train on the plain path. None
        when no net takes the kernel."""
        c = self.config_file
        if not c.bf16 or not c.fusedTrainKernel or self.device.type != "cuda":
            return None
        from .ops.kernels.nerf_train import NerfTrainKernel
        fns = [NerfTrainKernel(m) if isinstance(m, NeRFDef) and m.width % 128 == 0
               and m.width >= 128 else None for m in self.models]
        return fns if any(f is not None for f in fns) else None

    def learning_rate(self, epoch: int) -> float:
        """lrate * decay^((epoch - pretrain epochs) / steps), in fp32 on the
        host as the JAX step computes it on the device."""
        c = self.config_file
        pre = max(c.epochsPretrain) if c.epochsPretrain else 0
        x = torch.tensor(epoch - pre, dtype=torch.int32) / c.lrate_decay_steps
        return float(c.lrate * torch.tensor(c.lrate_decay, dtype=torch.float32) ** x)

    def make_loss_and_grads(self):
        """``fn(batch, targets, epoch) -> (per-net losses, per-net grads)``:
        the cascade, every loss of a net that trains at some epoch, the
        weighted sum (a net locked at this epoch weighs 0) and its gradient
        for every parameter, as {state_dict key: tensor} per net."""
        c = self.config_file
        dtype = torch.bfloat16 if c.bf16 else None
        apply_fns = self.train_apply_fns()

        def loss_and_grads(batch, targets, epoch):
            # each step's jitter comes from (seed, epoch), as the JAX step's
            # PRNGKey(epoch), so a resumed run draws what an unbroken one does
            self.generator.manual_seed(self.seed * 1_000_003 + int(epoch))
            generator = self.generator
            if self.ray_shard is not None:
                generator = RaySlice(generator, batch[DatasetKeys.ray_directions_samples].shape[0],
                                     *self.ray_shard)
            outs, dicts = run_cascade(self.models, self.f_in, batch, is_inference=False,
                                      generator=generator, dtype=dtype,
                                      apply_fns=apply_fns)
            total, per_net = None, []
            for i, crit in enumerate(self.losses):
                if crit is None or self.loss_weights[i] == 0 or not self.ever_unlocked(i):
                    per_net.append(torch.zeros((), device=self.device))
                    continue
                li = crit(outs[i], targets.get(i), inference_dicts=dicts, epoch=epoch)
                w = 0.0 if self.weights_locked(epoch, i) else self.loss_weights[i]
                total = w * li if total is None else total + w * li
                per_net.append(li.detach())
            params = [(i, k, p) for i, m in enumerate(self.models)
                      for k, p in m.named_parameters()]
            grads = [dict() for _ in self.models]
            found = [None] * len(params)
            if total is not None:
                found = torch.autograd.grad(total, [p for _, _, p in params], allow_unused=True)
            for (i, k, p), g in zip(params, found):
                grads[i][k] = torch.zeros_like(p) if g is None else g
            return per_net, grads

        return loss_and_grads

    def apply_updates(self, grads, epoch: int):
        """Adam on every net not locked at ``epoch``; a locked net keeps both
        its parameters and its optimizer state."""
        lr = self.learning_rate(epoch)
        for i, model in enumerate(self.models):
            if not self.weights_locked(epoch, i):
                adam_update(model, self.opt_states[i], grads[i], lr)

    def make_pretrain_step(self, model_idx: int):
        """``step(batch, targets, epoch, epoch0) -> loss``: one GT
        pretraining step of net ``model_idx`` alone. The earlier stages'
        outputs are their GT targets; the loss acts on the net's raw output
        from its plain forward (no K3, as JAX calls the net's own apply);
        Adam at lrate * decay^((epoch0 + epoch) / steps)."""
        c = self.config_file
        crit, model = self.losses[model_idx], self.models[model_idx]
        dtype = torch.bfloat16 if c.bf16 else None
        decay = torch.tensor(c.lrate_decay, dtype=torch.float32)

        def step(batch, targets, epoch, epoch0):
            self.generator.manual_seed(self.seed * 1_000_003 + int(epoch))
            prev = [{FSK.postprocessed_network_output: targets.get(j)} for j in range(model_idx)]
            d = self.f_in[model_idx].batch(batch, prev_outs=prev, is_inference=False,
                                           generator=self.generator)
            out = model(d[FSK.input_feature_batch], dtype)
            d[FSK.network_output] = out
            loss = crit(out, targets.get(model_idx), inference_dicts=[d], epoch=epoch,
                        inference_dict=d)
            params = list(model.named_parameters())
            found = torch.autograd.grad(loss, [p for _, p in params], allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(params, found)}
            x = torch.tensor(epoch0 + epoch, dtype=torch.int32) / c.lrate_decay_steps
            adam_update(model, self.opt_states[model_idx], grads,
                        float(c.lrate * decay ** x))
            return loss.detach()

        return step

    def make_train_step(self):
        """``step(batch, targets, epoch) -> per-net losses``: one training
        step, updating the parameters and optimizer states in place."""
        loss_and_grads = self.make_loss_and_grads()

        def step(batch, targets, epoch):
            per_net, grads = loss_and_grads(batch, targets, epoch)
            self.apply_updates(grads, epoch)
            return per_net

        return step

    # -- inference ----------------------------------------------------------

    def inference(self, batch):
        """The plain cascade with ``is_inference=True`` in the run's
        precision, without gradients: (per-net outputs, inference dicts)."""
        dtype = torch.bfloat16 if self.config_file.bf16 else None
        with torch.no_grad():
            return run_cascade(self.models, self.f_in, batch, is_inference=True,
                               generator=None, dtype=dtype)

    # -- checkpoints --------------------------------------------------------

    def save_weights(self, name_suffix: str, model_idx: int = -1, params_only: bool = False):
        """Checkpoint every (selected) net; params_only skips the optimizer
        state. Returns the paths written."""
        paths = []
        for i, m in enumerate(self.models):
            if model_idx in (-1, i):
                paths.append(os.path.join(self.logDir, f"{m.name}_{name_suffix}.weights"))
                save_tree(paths[-1], to_flat(m))
                if not params_only:
                    paths.append(os.path.join(self.logDir, f"{m.name}_{name_suffix}.optimizer"))
                    save_tree(paths[-1], adam_to_flat(self.opt_states[i]))
        if self.config_file.amp:
            # AMP-scaler placeholder of the reference's checkpoint layout
            save_tree(os.path.join(self.logDir, f"{name_suffix}.scale"),
                      {"scale": np.float32(1.0), "growth_tracker": np.int32(0)})
        return paths

    def _load_net(self, i: int, weights_path: str, with_optimizer: bool = True):
        load_flat(self.models[i], load_tree(weights_path))
        opt_path = weights_path.split('.weights')[0] + '.optimizer'
        if with_optimizer and os.path.exists(opt_path):
            adam_from_flat(self.opt_states[i], load_tree(opt_path))

    def _ckpt_candidates(self, path: str, name: str, include_opt=False):
        try:
            files = sorted(os.listdir(path))
        except OSError:
            return []
        return [os.path.join(path, f) for f in files if '.weights' in f and name in f
                and (include_opt or '_opt.weights' not in f)]

    def _try_resume_common_epoch(self) -> bool:
        """Resume every net from the newest epoch for which every net has a
        readable checkpoint; an unreadable epoch is skipped with a warning."""
        per_net = []
        for m in self.models:
            by_epoch = {}
            for p in self._ckpt_candidates(self.logDir, m.name):
                try:
                    by_epoch[int(p.split('.weights')[0].split('_')[-1])] = p
                except ValueError:
                    continue
            per_net.append(by_epoch)
        if not per_net or not all(per_net):
            return False
        common = set(per_net[0])
        for m in per_net[1:]:
            common &= set(m)
        for epoch in sorted(common, reverse=True):
            saved = [(to_flat(m), adam_to_flat(s)) for m, s in zip(self.models, self.opt_states)]
            try:
                for i in range(len(self.models)):
                    self._load_net(i, per_net[i][epoch])
            except Exception as e:  # any unreadable file (e.g. BadZipFile), as JAX
                print(f"checkpoint epoch {epoch} unreadable ({type(e).__name__}: {e}); "
                      "trying an older one")
                for i, (w, o) in enumerate(saved):  # no half-loaded state
                    load_flat(self.models[i], w)
                    adam_from_flat(self.opt_states[i], o)
                continue
            print(f"Reloading checkpoint from epoch {epoch} ({per_net[0][epoch]})")
            self.epoch0 = epoch + 1
            return True
        return False

    def teacher_experiment_name(self) -> str:
        """The dense run a fine run bootstraps from: this run's experiment
        name with its sample count and threshold set to the dense config's
        (``128_LSfCDA_(0.0)``)."""
        return re.sub(r"\d+_LSfCDA_\(\d+\.\d+\)", "128_LSfCDA_(0.0)", self.experiment_name)

    def load_latest_weights(self):
        """Resume from the newest complete checkpoint; otherwise bootstrap
        fine training from the dense run through the regex-derived
        experiment name, failing fast when that teacher is missing."""
        c = self.config_file
        if self._try_resume_common_epoch():
            return
        for i, m in enumerate(self.models):
            self.epoch0 = 1
            if (c.preTrainedSuffix != "" and c.adaptiveSamplingThreshold > 0
                    and c.preTrained and len(c.preTrained) > i):
                path = os.path.join(c.preTrained[i], self.teacher_experiment_name())
                cands = [x for x in self._ckpt_candidates(path, m.name, include_opt=True)
                         if c.preTrainedSuffix in x]
                if not cands:
                    raise FileNotFoundError(
                        f"dense-pretrained weights for '{m.name}' not found in {path} "
                        f"(suffix '{c.preTrainedSuffix}'); the teacher name is "
                        "regex-derived from THIS run's config — check that name-bearing "
                        "flags (loss blending, sample counts) match the dense run")
                print(f"loading dense-pretrained weights from {cands[-1]}")
                self._load_net(i, cands[-1])
            elif c.preTrained and len(c.preTrained) > i and c.preTrained[i].lower() != "none":
                wpath = os.path.join(c.preTrained[i], f"{m.name}.weights")
                if not os.path.exists(wpath):
                    wpath = os.path.join(c.preTrained[i], f"{m.name}__opt.weights")
                if os.path.exists(wpath):
                    print(f"loading pretrained weights from {wpath}")
                    self._load_net(i, wpath, with_optimizer=False)

    def load_specific_weights(self, name: str, model_idx: int = -1):
        """Load, for every (selected) net, the newest checkpoint in the log
        directory whose file name contains ``name`` (``_opt`` ones included),
        with its ``.optimizer`` file where there is one."""
        for i, m in enumerate(self.models):
            if model_idx in (-1, i):
                cands = [x for x in self._ckpt_candidates(self.logDir, m.name, include_opt=True)
                         if name in os.path.basename(x)]
                if not cands:
                    print("no Checkpoints found")
                    continue
                self._load_net(i, cands[-1])

    # -- batch assembly -----------------------------------------------------

    def assemble_host_batch(self, dataset: ViewCellDataset, image_indices: np.ndarray,
                            rays: slice = None):
        """Host-side gather of a multi-image ray batch and its colour
        targets as numpy arrays: per-image low-discrepancy pixel picks,
        image-major. ``rays`` keeps that slice of each image's picks (a
        rank's share; the picks are drawn whole, so every rank draws the
        same). Also returns the kept picks, (n_img, rays) flat pixel
        indices, from which ``assemble_train_batch`` builds the
        ``ClassifiedDepth`` target."""
        n_img, samples = len(image_indices), dataset.num_samples
        if rays is not None:
            samples = len(range(samples)[rays])
        dirs = np.zeros((n_img, samples, 3), np.float32)
        colors = depth_samples = placement = None
        tracker = getattr(dataset, "sample_placement_tracker", None)
        pixels = []
        for k, idx in enumerate(image_indices):
            pix = self.pixel_idx_sequence_gen.pixel_indices(dataset.num_samples, dataset.h,
                                                            dataset.w)
            if rays is not None:
                pix = pix[rays]
            pixels.append(pix)
            dirs[k] = dataset.directions[pix]
            if tracker is not None:
                if placement is None:
                    placement = np.zeros((n_img, samples, tracker.max_sample_count), np.float32)
                placement[k] = tracker.get_unpacked_image(idx).reshape(
                    dataset.h * dataset.w, -1)[pix]
            if dataset.color_images is not None:
                if colors is None:
                    colors = np.zeros((n_img, samples, 3), np.float32)
                colors[k] = dataset.color_images[idx].reshape(-1, 3)[pix]
            if dataset.depth_images is not None:
                if depth_samples is None:
                    depth_samples = np.zeros((n_img, samples, 1), np.float32)
                depth_samples[k] = dataset.depth_images[idx].reshape(-1, 1)[pix]
        batch = {DatasetKeys.image_pose: dataset.poses[image_indices],
                 DatasetKeys.image_rotation: dataset.rotations[image_indices],
                 DatasetKeys.ray_directions_samples: dirs}
        if depth_samples is not None:
            batch[DatasetKeys.depth_image_samples] = depth_samples.reshape(-1, 1)
        if placement is not None:
            batch[DatasetKeys.sample_placement] = placement.reshape(-1, placement.shape[-1])
        targets = {}
        for i, f_out in enumerate(self.f_out):
            kind = type(f_out).__name__
            if kind == "RGBARayMarch" and colors is not None:
                targets[i] = colors.reshape(-1, 3)
        return batch, targets, np.stack(pixels)

    def assemble_train_batch(self, dataset: ViewCellDataset, image_indices: np.ndarray,
                             rays: slice = None):
        """``assemble_host_batch`` moved to the training device, where a
        ``ClassifiedDepth`` net's target is built from the depth maps of the
        batch's images at the kept picks."""
        batch, host_targets, pixels = self.assemble_host_batch(dataset, image_indices, rays)
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        targets = {}
        for i, f_out in enumerate(self.f_out):
            if i in host_targets:
                targets[i] = to(host_targets[i])
            elif isinstance(f_out, ClassifiedDepth) and dataset.depth_images is not None:
                targets[i] = f_out.features_from_depth(to(dataset.depth_images[image_indices]),
                                                       to(pixels))
        return {k: to(v) for k, v in batch.items()}, targets
