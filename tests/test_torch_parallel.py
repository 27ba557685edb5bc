"""Training across processes (``diffsheg_tpu_torch/parallel/``) on the CPU.

Two real worker processes of ``parallel/mp_lockstep.py`` join a gloo
group over a local port (each wait bounded by a timeout): one pair
data-parallel, which also runs every collective, the loader partition,
a HuBERT-encoder payload and the test-set stream; one pair with the
parameters sharded by ``fully_shard``, which also saves a checkpoint.
They run while this process computes the JAX references.  Held:

  - the ranks agree bit for bit, and match one process at rtol 2e-5 /
    atol 1e-6 (loss of each of 3 steps, the parameters' L1 norm);
  - one process of the port against JAX's ``mp_lockstep.compute_lockstep``
    on the 8 virtual devices, on JAX's initial weights;
  - the BatchNorm of the HuBERT conv encoder takes the global batch's
    statistics: 2 processes against JAX's step sharded over 8 devices;
  - dropout and the classifier-free null rows drawn for the global batch:
    2 processes against one;
  - ``Trainer.evaluate``'s metrics reduced across processes: 2 against 1;
  - FSDP against data-parallel;
  - ``generate_testset`` striding 4 clips over 2 processes (rank 1 holding
    one clip with audio and one without) against one process, as JAX's
    ``_verify_testset`` checks it;
  - a checkpoint saved under FSDP resumes in one process.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread)

from diffsheg_tpu_torch.compat.from_jax import export_flax_tree
from diffsheg_tpu_torch.config import MeshConfig
from diffsheg_tpu_torch.models.factory import build_denoiser, random_init_
from diffsheg_tpu_torch.parallel import mp_lockstep as mp
from diffsheg_tpu_torch.parallel.mesh import mesh_shape

WORKER_TIMEOUT = 240.0


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both worker pairs, started at once in the background: (directory,
    HuBERT payload weights, {'ddp': future, 'fsdp': future})."""
    root = tmp_path_factory.mktemp("mp")
    cfg = mp.tiny_config(hubert=True)
    tree = export_flax_tree(random_init_(build_denoiser(cfg.model), 5,
                                         perturb=0.05))
    mp.save_weights(str(root / "hubert.npz"), tree)
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {
        "ddp": pool.submit(mp.spawn_workers, 2, WORKER_TIMEOUT, [
            "--device", "cpu", "--testset-dir", str(root / "testset"),
            "--hubert-weights", str(root / "hubert.npz"), "--dropout",
            "--evaluate"]),
        "fsdp": pool.submit(mp.spawn_workers, 2, WORKER_TIMEOUT, [
            "--device", "cpu", "--fsdp", "--ckpt-dir", str(root / "ckpt"), "--evaluate"])}
    yield root, tree, futures
    pool.shutdown(wait=True)


def result(spawned, kind):
    return spawned[2][kind].result(timeout=2 * WORKER_TIMEOUT)


def test_one_process_equals_jax_lockstep(spawned):
    """The port's step in one process, on JAX's initial weights, against
    JAX's ``compute_lockstep`` over the 8-device mesh."""
    from diffsheg_tpu.models.factory import init_denoiser
    from diffsheg_tpu.parallel import mp_lockstep as jmp
    assert jax.device_count() == 8
    want = jmp.compute_lockstep()
    jcfg = jmp.tiny_config()
    _, variables = init_denoiser(jcfg.model, jmp.T_FRAMES,
                                 jax.random.PRNGKey(jcfg.train.seed))
    got = mp.compute_lockstep(weights=jax.tree.map(np.asarray,
                                                   dict(variables)),
                              device="cpu")
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=2e-5,
                                   atol=1e-6, err_msg=key)


def test_batchnorm_takes_global_statistics_like_jax(spawned):
    """HuBERT features through the conv encoder, whose BatchNorm trains on
    the batch's statistics: 2 processes of the port (each normalising by
    the global batch's mean and E[x^2]) against JAX's step over the batch
    sharded across 8 devices, 3 steps: losses, parameters, running
    statistics."""
    from diffsheg_tpu.data.loader import ShardedBatchLoader
    from diffsheg_tpu.diffusion.schedule import (get_named_beta_schedule,
                                                 make_schedule)
    from diffsheg_tpu.parallel import mp_lockstep as jmp
    from diffsheg_tpu.parallel.mesh import make_mesh, shard_batch
    from diffsheg_tpu.train.step import create_train_state, make_train_step
    _, tree, _ = spawned
    base = jmp.tiny_config()
    jcfg = base.replace(model=dataclasses.replace(
        base.model, add_hubert=True, encode_hubert=True,
        hubert_dim=mp.HUBERT_DIM, hubert_latent_dim=8))
    mesh = make_mesh(jcfg.mesh)
    sched = make_schedule(get_named_beta_schedule(
        jcfg.diffusion.beta_schedule, jcfg.diffusion.num_steps))
    state = create_train_state(jcfg, jax.tree.map(jnp.asarray, tree),
                               mesh=mesh)
    step = make_train_step(jcfg, sched, mesh=mesh, inject_randoms=True)
    loader = ShardedBatchLoader(mp.SynthDataset(mp.tiny_config(hubert=True)),
                                global_batch_size=mp.GLOBAL_BATCH,
                                seed=jcfg.train.seed, prefetch=0)
    t, noise = mp.injected_randoms(jcfg)
    want, it = {}, iter(loader)
    for k in range(3):
        # host copies of the state each step: one compile for all three
        state, terms = step(jax.tree.map(np.asarray, state),
                            shard_batch(mesh, next(it)),
                            jnp.asarray(t, jnp.int32), jnp.asarray(noise))
        want[f"loss_{k}"] = float(terms.total)
    leaves = jax.tree_util.tree_leaves_with_path
    want["pnorm"] = float(sum(np.abs(np.asarray(x, np.float64)).sum()
                              for x in jax.tree.leaves(state.params)))
    for key, leaf in (("bn_mean", "mean"), ("bn_var", "var")):
        want[key] = float(sum(
            np.asarray(x, np.float64).sum()
            for path, x in leaves(state.batch_stats)
            if path[-1].key == leaf))
    assert want["bn_var"] > 0 and abs(want["bn_mean"]) > 1e-2
    got = [w["hubert"] for w in result(spawned, "ddp")]
    mp.check_lockstep(got, want)


def test_collectives_and_loader_partition_across_processes(spawned):
    mp.check_workers(result(spawned, "ddp"), 2)
    mp.check_workers(result(spawned, "fsdp"), 2)


def test_two_processes_equal_one(spawned):
    """Loss of each step and the parameters after 3 steps: the ranks
    agree bit for bit and equal one process at rtol 2e-5 / atol 1e-6."""
    reference = mp.compute_lockstep(device="cpu")
    assert reference["loss_2"] < reference["loss_0"]
    mp.check_lockstep(result(spawned, "ddp"), reference)


def test_dropout_and_null_rows_follow_the_global_batch(spawned):
    """Dropout masks and the classifier-free null rows are drawn for the
    global batch and cut to each process's rows: 2 processes still equal
    one (the null rows, the first quarter of the batch, all fall in rank
    0's rows)."""
    reference = mp.compute_lockstep(mp.tiny_config(dropout=True),
                                    device="cpu")
    plain = mp.compute_lockstep(device="cpu")
    assert reference["loss_0"] != plain["loss_0"]
    mp.check_lockstep([w["dropout"] for w in result(spawned, "ddp")],
                      reference)


def test_evaluation_reduces_across_processes(spawned):
    """``Trainer.evaluate`` over 2 processes, each scoring its rows with
    its default noise (its rows of the global batch's draws), returns one
    process's MSE, PCK and PCK@2 on every process; so does a trainer whose
    parameters are sharded (its generator gathers them)."""
    want = mp.check_evaluate(device="cpu")
    for kind in ("ddp", "fsdp"):
        mp.check_lockstep([w["evaluate"] for w in result(spawned, kind)],
                          want)


def test_fsdp_equals_data_parallel(spawned):
    ddp, fsdp = result(spawned, "ddp"), result(spawned, "fsdp")
    keys = ["loss_0", "loss_1", "loss_2", "pnorm"]
    mp.check_lockstep(fsdp, {k: ddp[0][k] for k in keys})


def test_testset_stream_across_processes(spawned, tmp_path):
    mp.verify_testset(result(spawned, "ddp"), 2, str(tmp_path),
                      device="cpu")


def test_fsdp_checkpoint_resumes_in_one_process(spawned, tmp_path):
    """Process 0 of the FSDP pair wrote the full state after 3 steps: it
    loads into one process's unsharded state with the same parameters,
    holds the same keys as a one-process checkpoint, and a 4th step from
    it equals 4 uninterrupted steps of one process."""
    from diffsheg_tpu_torch.data.loader import ShardedBatchLoader
    from diffsheg_tpu_torch.diffusion.schedule import (
        get_named_beta_schedule, make_schedule)
    from diffsheg_tpu_torch.models.factory import init_denoiser
    from diffsheg_tpu_torch.parallel.mesh import shard_batch
    from diffsheg_tpu_torch.train.checkpoint import (CheckpointManager,
                                                     read_state_file)
    from diffsheg_tpu_torch.train.step import (create_train_state,
                                               make_train_step)
    root = spawned[0]
    fsdp = result(spawned, "fsdp")
    cfg = mp.tiny_config()
    state = create_train_state(cfg, init_denoiser(cfg.model, seed=7), "cpu")
    restored, _ = CheckpointManager(str(root / "ckpt")).restore_latest(state)
    assert restored.step == 3
    assert mp.params_l1(restored.model) == fsdp[0]["pnorm"]

    one = str(tmp_path / "one")
    uninterrupted = mp.compute_lockstep(n_steps=4, ckpt_dir=one,
                                        device="cpu")
    sharded = read_state_file(str(root / "ckpt" / "latest" / "3"))
    plain = read_state_file(str(tmp_path / "one" / "latest" / "4"))
    assert sharded["model"].keys() == plain["model"].keys()
    assert (sharded["optimizer"]["param_groups"]
            == plain["optimizer"]["param_groups"])
    assert sharded["optimizer"]["state"].keys() == plain["optimizer"][
        "state"].keys()

    sched = make_schedule(get_named_beta_schedule(
        cfg.diffusion.beta_schedule, cfg.diffusion.num_steps))
    step = make_train_step(cfg, sched, inject_randoms=True)
    loader = ShardedBatchLoader(mp.SynthDataset(cfg),
                                global_batch_size=mp.GLOBAL_BATCH,
                                seed=cfg.train.seed, prefetch=0)
    fourth = list(loader)[3]
    t, noise = mp.injected_randoms(cfg)
    restored, terms = step(restored, shard_batch(fourth, "cpu"),
                           torch.from_numpy(t), torch.from_numpy(noise))
    np.testing.assert_allclose(float(terms.total), uninterrupted["loss_3"],
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(mp.params_l1(restored.model),
                               uninterrupted["pnorm"], rtol=2e-5)


@pytest.mark.parametrize("dp,fsdp,n,want", [
    (-1, 1, 4, (4, 1)), (-1, 2, 4, (2, 2)), (2, 2, 4, (2, 2)),
    (1, 4, 4, (1, 4)), (-1, 1, 1, (1, 1)),
    (2, 1, 1, None), (-1, 3, 4, None), (2, 2, 2, None)])
def test_mesh_shape_follows_jax(dp, fsdp, n, want):
    """The (data, fsdp) degrees and the mesh-size error of JAX's
    ``make_mesh`` over as many devices as processes."""
    from diffsheg_tpu.config import MeshConfig as JMesh
    from diffsheg_tpu.parallel.mesh import make_mesh as jmake_mesh
    cfg = MeshConfig(data_parallel=dp, fsdp_parallel=fsdp)
    devices = jax.devices()[:n]
    if want is None:
        with pytest.raises(ValueError) as ours:
            mesh_shape(cfg, n)
        with pytest.raises(ValueError) as theirs:
            jmake_mesh(JMesh(data_parallel=dp, fsdp_parallel=fsdp), devices)
        assert str(ours.value) == str(theirs.value)
    else:
        assert mesh_shape(cfg, n) == want
        jm = jmake_mesh(JMesh(data_parallel=dp, fsdp_parallel=fsdp), devices)
        assert tuple(jm.shape.values()) == want


def test_one_process_collectives_return_their_input():
    from diffsheg_tpu_torch.parallel import collectives as col
    x = np.arange(6.0).reshape(3, 2)
    assert col.process_count() == 1 and col.process_index() == 0
    assert col.global_rows(5) == (0, 5)
    assert col.all_reduce_mean_metrics({"a": 2.5}, weight=3.0) == {"a": 2.5}
    assert col.all_reduce_nanmean_metrics({"a": float("nan")}, 0.0)["a"] \
        != 0.0
    assert np.array_equal(col.gather_arrays(x), x)
    assert np.array_equal(col.gather_arrays_ragged(x), x)
    t = torch.arange(3.0)
    assert col.mean_across_processes_(t) is t
    assert col.gather_rows(t) is t and col.sum_across_processes(t) is t
    col.barrier("alone")
