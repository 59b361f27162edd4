"""The port's ray-data-parallel step (adanerf_tpu_torch/parallel/mesh.py)
on the CPU, counterpart of tests/test_parallel.py: two gloo ranks, each in
a process of its own, step on their halves of every image's rays and
all-reduce their gradients; the result is held against the one-process
step on the same global batches, with JAX's bars (tests/test_parallel.py):
parameters within rtol 2e-5 / atol 2e-6 and losses within rtol 1e-5. The
ranks' parameters must agree bit for bit. The one-process port step is
held against the JAX single-device step on the same batch (the bars of
tests/test_torch_train_step.py: losses rtol 1e-5, every gradient leaf 1e-4
of its max |ref|), and a batch's inference sharded over its rays against
the whole batch's (atol 1e-6, tests/test_parallel.py's bar). Each spawned
process has a timeout."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adanerf_tpu.config import Config as JConfig
from adanerf_tpu.train_state import TrainState as JTrainState
from adanerf_tpu_torch.ops.draws import RaySlice, rand, randn
from adanerf_tpu_torch.parallel import check, mesh
from adanerf_tpu_torch.pipeline.keys import DatasetKeys
from adanerf_tpu_torch.pipeline.losses import get_loss_by_name
from adanerf_tpu_torch.utils.weights import flatten_params, from_jax_params

from scene_utils import dense_config_args, make_scene

TIMEOUT = 240  # seconds for a group of rank processes


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("scene_tpar")), with_depth=True)


def _argv(scene, log, extra=()):
    return dense_config_args(scene, log, samples=48) + ["--randomSeed", "3", *extra,
                                                        "--device", "cpu"]


@pytest.mark.parametrize("extra", [[], ["--adaptiveSamplingThreshold", "0.2"], ["--perturb"]],
                         ids=["dense", "adaptive", "perturb"])
def test_two_rank_step_matches_one_process(scene, tmp_path, extra):
    argv = _argv(scene, str(tmp_path / "logs"), extra)
    n_steps, epoch0 = 2, 3
    mesh.run_ranks(check.rank_steps, (argv, n_steps, epoch0, str(tmp_path)),
                   ["cpu", "cpu"], str(tmp_path), timeout=TIMEOUT)
    ranks = check.rank_records(str(tmp_path), 2)
    ref = check.one_process_steps(argv, "cpu", n_steps, epoch0)
    params = [k for k in ref if k.startswith("param/")]
    assert params and all(k in ranks[0] for k in params)
    for k in params:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
        np.testing.assert_allclose(ranks[0][k], ref[k], rtol=2e-5, atol=2e-6, err_msg=k)
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=1e-5)
    for k in (k for k in ref if k.startswith("grad/")):
        scale = float(np.abs(ref[k]).max()) + 1e-20
        assert float(np.abs(ranks[0][k] - ref[k]).max()) / scale <= 1e-5, k


def test_one_process_step_matches_jax(scene, tmp_path):
    """The step the ranks average, alone, against JAX's single-device step
    from the same parameters on the same batch."""
    argv = _argv(scene, str(tmp_path / "logs"))
    jts = JTrainState()
    jts.initialize(JConfig.init(argv=argv[:-2]))  # JAX has no --device
    tts = check.train_state(argv, "cpu")
    for m, p in zip(tts.models, jts.params):
        from_jax_params(m, jax.tree.map(np.asarray, p))
    idx, epoch = np.array([1, 3]), 12
    jb, jt = jts.assemble_train_batch(jts.train_dataset, idx)
    tb, tt = tts.assemble_train_batch(tts.train_dataset, idx)

    def loss_fn(params):
        from adanerf_tpu.pipeline.cascade import run_cascade
        outs, dicts = run_cascade(jts.model_defs, params, jts.f_in, jb, is_inference=False,
                                  key=None, dtype=None)
        per_net = [crit(outs[i], jt.get(i), inference_dicts=dicts, epoch=jnp.asarray(epoch))
                   for i, crit in enumerate(jts.losses)]
        assert not any(jts.weights_locked(epoch, i) for i in range(len(per_net)))
        return sum(w * li for w, li in zip(jts.loss_weights, per_net)), per_net

    j_grads, j_losses = jax.grad(loss_fn, has_aux=True)(jts.params)
    t_losses, t_grads = mesh.shard_loss_and_grads(tts, None)(tb, tt, epoch)
    np.testing.assert_allclose([float(v) for v in t_losses], [float(v) for v in j_losses],
                               rtol=1e-5, atol=1e-8)
    for i, g in enumerate(j_grads):
        for k, ref in flatten_params(jax.tree.map(np.asarray, g)).items():
            rel = float(np.abs(t_grads[i][k].numpy() - ref).max()) / (
                float(np.abs(ref).max()) + 1e-20)
            assert rel <= 1e-4, (i, k, rel)


@pytest.mark.parametrize("world", [2, 4])
def test_rank_batch_is_its_slice_of_the_whole_batch(scene, tmp_path, world):
    """Every ray-indexed array of a rank's batch holds the same (image, ray)
    pairs: the rank's gather equals its slice of the whole batch, the GT
    depth samples included."""
    argv = _argv(scene, str(tmp_path / "logs"), ["--trainWithGTDepth"])
    idx = np.array([2, 0])
    ts = check.train_state(argv, "cpu")
    whole, whole_t = ts.assemble_train_batch(ts.train_dataset, idx)
    assert DatasetKeys.depth_image_samples in whole
    for rank in range(world):
        rays = slice(rank * 48 // world, (rank + 1) * 48 // world)
        ts = check.train_state(argv, "cpu")
        got, got_t = ts.assemble_train_batch(ts.train_dataset, idx, rays)
        want, want_t = mesh.slice_batch(whole, whole_t, rays)
        assert sorted(got) == sorted(want) and sorted(got_t) == sorted(want_t)
        for k in want:
            torch.testing.assert_close(got[k], want[k].contiguous(), rtol=0, atol=0)
        for k in want_t:
            torch.testing.assert_close(got_t[k], want_t[k], rtol=0, atol=0)


def test_local_batch_slice(monkeypatch):
    """Contiguous equal slices in rank order; rays that do not divide over
    the ranks are refused, as JAX asserts."""
    assert mesh.local_batch_slice(None, 4096) == slice(0, 4096)
    monkeypatch.setattr(mesh, "rank_and_size", lambda group: (1, 4))
    assert mesh.local_batch_slice("group", 4096) == slice(1024, 2048)
    monkeypatch.setattr(mesh, "rank_and_size", lambda group: (1, 3))
    with pytest.raises(ValueError, match="do not split"):
        mesh.local_batch_slice("group", 4096)


@pytest.mark.parametrize("fn", [rand, randn])
def test_ray_slice_draws_keep_the_rank_rays(fn):
    """A rank's draws are its rays' share of the whole batch's draws."""
    n_img, per, world = 3, 8, 4
    g = torch.Generator().manual_seed(5)
    whole = fn((n_img * per * world, 16), g, "cpu").reshape(n_img, world * per, 16)
    for rank in range(world):
        g.manual_seed(5)
        got = fn((n_img * per, 16), RaySlice(g, n_img, rank, world), "cpu")
        torch.testing.assert_close(got, whole[:, rank * per:(rank + 1) * per].reshape(-1, 16),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_inference_matches_single(scene, tmp_path, n_shards):
    """The cascade's inference (test.py semantics) on each shard of a
    batch's rays, put back together, against the whole batch's: no
    cross-ray coupling anywhere in the pipeline."""
    ts = check.train_state(_argv(scene, str(tmp_path / "logs"),
                                 ["--adaptiveSamplingThreshold", "0.2"]), "cpu")
    batch, targets = ts.assemble_train_batch(ts.train_dataset, np.array([0, 1]))
    ref = ts.inference(batch)[0][-1].reshape(2, 48, 3)
    per = 48 // n_shards
    parts = []
    for s in range(n_shards):
        b, _ = mesh.slice_batch(batch, targets, slice(s * per, (s + 1) * per))
        b = {k: v.contiguous() for k, v in b.items()}
        parts.append(ts.inference(b)[0][-1].reshape(2, per, 3))
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), ref.numpy(), atol=1e-6)


def _ce_rank(rank, group, device, out_dir):
    """A rank's weighted cross entropy on its half of one batch: the
    group's mean of the terms and of their gradients."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((64, 17)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 17, (64, 1)).astype(np.float32))
    labels[::5] = 16.0  # the weighted loss's class of weight 0
    crit = get_loss_by_name("CrossEntropyLossWeighted",
                            type("C", (), {"multiDepthFeatures": [16]})(), 0)
    crit.group = group
    x = logits[rank * 32:(rank + 1) * 32].clone().requires_grad_(True)
    loss = crit(x, labels[rank * 32:(rank + 1) * 32])
    loss.backward()
    grads = torch.zeros(64 * 17)
    grads[rank * 32 * 17:(rank + 1) * 32 * 17] = x.grad.reshape(-1)
    out = torch.cat([loss.detach().reshape(1), grads])
    torch.distributed.all_reduce(out, group=group)
    np.save(f"{out_dir}/ce{rank}.npy", (out / 2).numpy())


def test_weighted_cross_entropy_over_ranks_is_the_whole_batch(tmp_path):
    """A ratio-of-sums loss: two ranks' mean term and mean gradient equal
    the whole batch's loss and gradient."""
    mesh.run_ranks(_ce_rank, (str(tmp_path),), ["cpu", "cpu"], str(tmp_path), timeout=TIMEOUT)
    got = np.load(tmp_path / "ce0.npy")
    np.testing.assert_array_equal(got, np.load(tmp_path / "ce1.npy"))
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((64, 17)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 17, (64, 1)).astype(np.float32))
    labels[::5] = 16.0
    crit = get_loss_by_name("CrossEntropyLossWeighted",
                            type("C", (), {"multiDepthFeatures": [16]})(), 0)
    x = logits.clone().requires_grad_(True)
    loss = crit(x, labels)
    loss.backward()
    np.testing.assert_allclose(got[0], float(loss.detach()), rtol=1e-6)
    np.testing.assert_allclose(got[1:], x.grad.reshape(-1).numpy(), rtol=1e-5, atol=1e-9)
