"""The port's ``parallel/`` (meshes, the data-parallel steps) and the
trainer's mesh path against the JAX package's, on the CPU.

The JAX package runs on its virtual CPU devices (tests/conftest.py forces
8); the port's data axis is a ``gloo`` process group: of world size 1 in
this process, or of two spawned processes (``file://`` init under
``tmp_path``, a timeout of their own). Weights start from the JAX init,
carried across by ``models/weights.from_flax_variables``.

Tolerances, fixed before measuring:
- the world-size-1 steps against the single-device step: bit for bit;
- the two-process steps against the JAX package's ``parallelize_training``
  and ``shard_map_train_step`` on 2 virtual devices: the JAX tests' own
  bars (tests/test_parallel.py), loss rtol 1e-5, every parameter atol
  5e-3 after one Adam step; both ranks' parameters equal bit for bit
  (replicated). Adam's first step moves a parameter by about lr = 1e-3
  whatever its gradient, so the gradients themselves are held by one SGD
  step at lr 1 (``test_two_process_gradients_match_jax``): every leaf's
  change within 1e-3 of its own max-abs change, leaves zero to rounding
  below 1e-4 of the largest (its docstring states the rule);
- the mean of the ranks' losses against the global batch's: rtol 1e-6.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from robotic_discovery_platform_tpu import parallel as jparallel
from robotic_discovery_platform_tpu.models import losses as jlosses
from robotic_discovery_platform_tpu.models.unet import build_unet, init_unet
from robotic_discovery_platform_tpu.training import trainer as jtrainer
from robotic_discovery_platform_tpu.utils import config as jconfig
from robotic_discovery_platform_tpu_torch.models import losses as tlosses
from robotic_discovery_platform_tpu_torch.models import unet as tunet
from robotic_discovery_platform_tpu_torch.models.weights import (
    from_flax_variables,
    to_flax_variables,
)
from robotic_discovery_platform_tpu_torch.parallel import dp
from robotic_discovery_platform_tpu_torch.parallel import mesh as tmesh
from robotic_discovery_platform_tpu_torch.training import synthetic, trainer
from robotic_discovery_platform_tpu_torch.utils.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TINY = ModelConfig(base_features=8, compute_dtype="float32",
                   conv_impl="flax")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread for this module (see
    tests/test_torch_port_pipeline.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(n=8):
    """tests/test_parallel.py's batch."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(n, 32, 32, 3)).astype(np.float32)
    y = (rng.uniform(size=(n, 32, 32, 1)) > 0.5).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def jax_init():
    model = build_unet(jconfig.ModelConfig(**dataclasses.asdict(TINY)))
    variables = jax.device_get(jax.jit(lambda k: init_unet(model, k, 32))(
        jax.random.key(0)))
    return model, variables


def _port_net(variables) -> tunet.UNet:
    net = tunet.UNet(TINY)
    net.load_state_dict(from_flax_variables(variables))
    return net


# -- meshes ---------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    MeshConfig(data=-1), MeshConfig(data=2, spatial=2, model=2),
    MeshConfig(data=4, model=2), MeshConfig(data=3),
    MeshConfig(data=-1, spatial=3)])
def test_make_mesh_shapes_and_errors_match_jax(cfg):
    jcfg = jconfig.MeshConfig(**dataclasses.asdict(cfg))
    try:
        want = dict(jparallel.make_mesh(jcfg, devices=jax.devices()[:8]).shape)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            tmesh.make_mesh(cfg, devices=[CPU] * 8)
        assert str(got.value) == str(exc)
        return
    mesh = tmesh.make_mesh(cfg, devices=[CPU] * 8)
    assert mesh.shape == want
    assert mesh.devices.shape == tuple(want[a] for a in tmesh.AXES)


def test_available_devices_and_bring_up():
    assert tmesh.available_devices("cpu") == [CPU]
    assert tmesh.make_mesh(MeshConfig(), device_type="cpu").shape == {
        "data": 1, "spatial": 1, "model": 1}
    with pytest.raises(ValueError, match="unknown device type"):
        tmesh.available_devices("tpu")
    # one process: a no-op, as jax.distributed in the JAX package
    tmesh.initialize_distributed(None, 1, 0)
    tmesh.initialize_distributed("localhost:1", None, None)
    assert tmesh.data_rank() == (0, 1)


def test_tp_param_specs_match_jax(jax_init):
    _, variables = jax_init
    for min_channels in (64, 256):
        want = jparallel.tp_param_specs(variables["params"], min_channels)
        flat = {}
        for path, spec in jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec))[0]:
            flat[".".join(p.key for p in path)] = tuple(spec)
        net = _port_net(variables)
        got = tmesh.tp_param_specs(net.named_parameters(), min_channels)
        assert got == flat
        assert any(s for s in got.values()) == (min_channels == 64)


def test_model_and_spatial_placement_is_executed(monkeypatch):
    """Over a 1x2x2 mesh: a mesh whose size is not the world size is
    refused; each rank (``data_rank`` standing in for its process) sits at
    its row-major coordinate, ``shard_pytree`` gives it the ``Cout / 2``
    slice of every kernel the specs split (the rest whole), and
    ``put_global_batch(spatial=True)`` its H block of the batch."""
    net = tunet.UNet(TINY).init_weights(torch.Generator().manual_seed(0))
    opt = trainer.make_optimizer(net, 1e-3)
    mesh = tmesh.make_mesh(MeshConfig(data=1, spatial=2, model=2),
                           devices=[CPU] * 4)
    for call in (lambda: tmesh.mesh_groups(mesh),
                 lambda: dp.parallelize_training(mesh, net, opt,
                                                 tlosses.bce_with_logits),
                 lambda: dp.shard_map_train_step(mesh, net, opt,
                                                 tlosses.bce_with_logits),
                 lambda: dp.put_global_batch(mesh, np.zeros((2, 4, 4, 3)))):
        with pytest.raises(ValueError, match="world size is 1"):
            call()
    state = dict(net.state_dict())
    specs = tmesh.tp_param_specs(state, 32)
    assert any(specs.values())
    x = np.arange(2 * 8 * 4 * 3, dtype=np.float32).reshape(2, 8, 4, 3)
    for rank in range(4):
        monkeypatch.setattr(tmesh, "data_rank", lambda rank=rank: (rank, 4))
        d, s, m = tmesh.mesh_coord(mesh)
        assert (d, s, m) == (0, rank // 2, rank % 2)
        placed = tmesh.shard_pytree(mesh, state, specs)
        for name, spec in specs.items():
            want = state[name]
            if spec:
                c = want.shape[-1] // 2
                want = want[..., m * c:(m + 1) * c]
            assert torch.equal(placed[name], want), (rank, name)
        got = dp.put_global_batch(mesh, x, spatial=True)
        assert torch.equal(got, torch.from_numpy(x[:, 4 * s:4 * s + 4]))
        assert torch.equal(dp.put_global_batch(mesh, x), torch.from_numpy(x))
    with pytest.raises(ValueError, match="not divisible by the spatial"):
        dp.put_global_batch(mesh, x[:, :7], spatial=True)


def test_put_global_batch_and_replicated_placement(monkeypatch):
    mesh = tmesh.make_mesh(MeshConfig(data=1), devices=[CPU])
    x = np.arange(24, dtype=np.float32).reshape(4, 2, 3)
    got = dp.put_global_batch(mesh, x)
    assert got.dtype == torch.float32 and torch.equal(got,
                                                      torch.from_numpy(x))
    two = tmesh.make_mesh(MeshConfig(data=2), devices=[CPU] * 2)
    # rank 0 of a two-rank axis (data_rank standing in for its process)
    # takes the first half
    with monkeypatch.context() as patch:
        patch.setattr(tmesh, "data_rank", lambda: (0, 2))
        with pytest.raises(ValueError, match="not divisible by the data "
                                             "axis"):
            dp.put_global_batch(two, np.zeros((3, 2)))
        assert torch.equal(dp.put_global_batch(two, x),
                           torch.from_numpy(x[:2]))
    tree = {"a": torch.ones(2), "b": {"c": torch.zeros(3)}}
    placed = tmesh.shard_pytree(mesh, tree)
    assert torch.equal(placed["b"]["c"], tree["b"]["c"])
    assert tmesh.replicated(mesh).spec == ()
    assert tmesh.batch_sharding(mesh).spec == ("data",)


@pytest.mark.parametrize("loss", ["bce", "dice", "bce_dice"])
def test_mean_of_shard_losses_is_the_global_loss(loss):
    """With equal shards the mean of the ranks' losses is the global
    batch's: the BCE is a pixel mean and the dice a per-sample mean."""
    fn = tlosses.make_loss_fn(loss, 0.5)
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(size=(8, 16, 16, 1))
                              .astype(np.float32))
    y = torch.from_numpy((rng.random((8, 16, 16, 1)) > 0.5)
                         .astype(np.float32))
    whole = float(fn(logits, y))
    halves = [float(fn(logits[i:i + 4], y[i:i + 4])) for i in (0, 4)]
    np.testing.assert_allclose(np.mean(halves), whole, rtol=1e-6)


# -- world size 1, in this process ----------------------------------------------


@pytest.fixture
def gloo_one(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        yield tmesh.make_mesh(MeshConfig(data=1), devices=[CPU])
    finally:
        dist.destroy_process_group()


def test_world_size_one_steps_equal_the_single_step(gloo_one, jax_init):
    _, variables = jax_init
    x, y = _batch(4)
    net0 = _port_net(variables)
    opt0 = trainer.make_optimizer(net0, 1e-3)
    loss0 = trainer.train_step(net0, opt0, tlosses.bce_with_logits,
                               torch.from_numpy(x), torch.from_numpy(y))
    want = net0.state_dict()
    for kind in ("parallelize_training", "shard_map_train_step"):
        net = _port_net(variables)
        opt = trainer.make_optimizer(net, 1e-3)
        if kind == "parallelize_training":
            step, evals, state = dp.parallelize_training(
                gloo_one, net, opt, tlosses.bce_with_logits)
            # the data x spatial group has one rank: no DDP wrapper
            # (parallel/dp.py)
            assert type(state.net) is tunet.UNet and state.sharded == ()
            assert state.module is state.net
        else:
            state = dp.replicated_state(gloo_one, net, opt)
            step = dp.shard_map_train_step(gloo_one, net, opt,
                                           tlosses.bce_with_logits)
        state, loss = step(state, x, y)
        assert float(loss) == float(loss0), kind
        got = state.net.state_dict()
        assert list(got) == list(want)  # no "module." prefix
        for k in want:
            assert torch.equal(got[k], want[k]), (kind, k)
    metrics = evals(state, x, y)
    single = trainer.eval_step(net0, tlosses.bce_with_logits,
                               torch.from_numpy(x), torch.from_numpy(y))
    for k in single:
        assert float(metrics[k]) == float(single[k])


def test_train_model_with_a_mesh(gloo_one, tmp_path):
    """``train_model(mesh=...)`` over the data axis: plain convs, the
    batch rounded to the data axis, one epoch; its checkpoint and its
    registered version load into the single-device trainer's net; scan is
    refused with a mesh, as in the JAX package."""
    imgs, masks = synthetic.generate_arrays(16, 32, 32, seed=1)
    cfg = TrainConfig(epochs=1, batch_size=4, img_size=32,
                      tracking_uri=f"file:{tmp_path}/mlruns",
                      checkpoint_dir=f"{tmp_path}/ckpt",
                      validation_split=0.25, async_checkpointing=False)
    res = trainer.train_model(
        cfg, dataclasses.replace(TINY, conv_impl="auto"),
        arrays=(imgs, masks), mesh=gloo_one, register=True, device="cpu")
    assert np.isfinite(res.best_val_loss) and res.registry_version == 1
    from robotic_discovery_platform_tpu_torch.training.checkpoint import (
        CheckpointManager,
    )

    state = CheckpointManager(cfg.checkpoint_dir).restore()
    net = tunet.UNet(TINY)
    net.load_state_dict(state["model"], strict=True)
    assert not any(k.startswith("module.") for k in state["model"])
    with pytest.raises(ValueError, match="no mesh"):
        trainer.train_model(dataclasses.replace(cfg, epoch_mode="scan"),
                            TINY, arrays=(imgs, masks), mesh=gloo_one,
                            register=False, device="cpu")


# -- two processes against the JAX package's 2 virtual devices -------------------

WORKER = textwrap.dedent('''
    import json, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    from robotic_discovery_platform_tpu_torch.models import losses, unet
    from robotic_discovery_platform_tpu_torch.parallel import dp, mesh as M
    from robotic_discovery_platform_tpu_torch.training import trainer
    from robotic_discovery_platform_tpu_torch.utils.config import (
        MeshConfig, ModelConfig, TrainConfig)
    rank, root = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=f"file://{root}/pg",
                            world_size=2, rank=rank)
    try:
        cfg = ModelConfig(base_features=8, compute_dtype="float32",
                          conv_impl="flax")
        init = torch.load(f"{root}/init.pt")
        data = np.load(f"{root}/batch.npz")
        x, y = data["x"], data["y"]
        mesh = M.make_mesh(MeshConfig(data=2), devices=[torch.device("cpu")] * 2)
        out = {}
        for kind in ("pjit", "shard_map"):
            for rule in ("adam", "sgd"):
                net = unet.UNet(cfg)
                net.load_state_dict(init)
                opt = (trainer.make_optimizer(net, 1e-3) if rule == "adam"
                       else torch.optim.SGD(net.parameters(), lr=1.0))
                if kind == "pjit":
                    step, _, state = dp.parallelize_training(
                        mesh, net, opt, losses.bce_with_logits)
                else:
                    state = dp.replicated_state(mesh, net, opt)
                    step = dp.shard_map_train_step(mesh, net, opt,
                                                   losses.bce_with_logits)
                state, loss = step(state, x, y)
                out[kind + ("" if rule == "adam" else "_sgd")] = float(loss)
                torch.save(state.net.state_dict(),
                           f"{root}/{kind}{'' if rule == 'adam' else '_sgd'}"
                           f"{rank}.pt")
        res = trainer.train_model(
            TrainConfig(epochs=1, batch_size=3, img_size=32,
                        tracking_uri=f"file:{root}/mlruns",
                        checkpoint_dir=f"{root}/ckpt",
                        validation_split=0.25, async_checkpointing=False),
            cfg, arrays=(data["imgs"], data["masks"]), mesh=mesh,
            register=True, device="cpu")
        out["train"] = [res.run_id, res.registry_version,
                        float(res.best_val_loss)]
        print(json.dumps(out))
    finally:
        dist.destroy_process_group()
''')


@pytest.fixture(scope="module")
def two_ranks(jax_init, tmp_path_factory):
    _, variables = jax_init
    root = tmp_path_factory.mktemp("dp2")
    x, y = _batch(8)
    imgs, masks = synthetic.generate_arrays(16, 32, 32, seed=1)
    np.savez(root / "batch.npz", x=x, y=y, imgs=imgs, masks=masks)
    torch.save(from_flax_variables(variables), root / "init.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r),
                               str(root)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:  # both collected before anything is asserted
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
    return root, [json.loads(o.strip().splitlines()[-1]) for _, o, _ in outs]


def _jax_steps(jax_init, tx=None):
    """The JAX tests' steps on 2 virtual devices, from the same init
    (Adam at 1e-3 unless ``tx`` is given)."""
    model, variables = jax_init
    tx = optax.adam(1e-3) if tx is None else tx
    state = jtrainer.TrainState(
        params=variables["params"], opt_state=tx.init(variables["params"]),
        batch_stats=variables["batch_stats"],
        epoch=jnp.asarray(0, jnp.int32),
        best_val_loss=jnp.asarray(jnp.inf, jnp.float32))
    x, y = (jnp.asarray(a) for a in _batch(8))
    mesh = jparallel.make_mesh(jconfig.MeshConfig(data=2),
                               devices=jax.devices()[:2])
    train, _, sharded = jparallel.parallelize_training(
        mesh, model, tx, jlosses.bce_with_logits, state, donate=False)
    s_p, l_p = train(sharded, x, y)
    step = jparallel.shard_map_train_step(mesh, model, tx,
                                          jlosses.bce_with_logits,
                                          donate=False)
    s_s, l_s = step(state, x, y)
    return {"pjit": (float(l_p), jax.device_get(s_p.params)),
            "shard_map": (float(l_s), jax.device_get(s_s.params))}


def _flat(tree: dict, prefix: str = "", dtype=np.float32) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}.", dtype))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, dtype)
    return out


def test_two_process_steps_match_jax(two_ranks, jax_init):
    root, outs = two_ranks
    want = _jax_steps(jax_init)
    for kind in ("pjit", "shard_map"):
        jloss, jparams = want[kind]
        assert outs[0][kind] == outs[1][kind]  # the all-reduced loss
        np.testing.assert_allclose(outs[0][kind], jloss, rtol=1e-5)
        r0 = torch.load(root / f"{kind}0.pt")
        r1 = torch.load(root / f"{kind}1.pt")
        for k in r0:  # replicated: both ranks hold the same state
            assert torch.equal(r0[k], r1[k]), (kind, k)
        net = tunet.UNet(TINY)
        net.load_state_dict(r0)
        got = _flat(to_flax_variables(net)["params"])
        flat = _flat(jparams)
        assert sorted(got) == sorted(flat)
        for k in flat:
            np.testing.assert_allclose(got[k], flat[k], atol=5e-3,
                                       err_msg=f"{kind} {k}")


def test_two_process_gradients_match_jax(two_ranks, jax_init):
    """One SGD step at lr 1 from the same init, on both sides: each
    parameter's change is minus the all-reduced gradient, which holds the
    cross-rank gradient (through the global BatchNorm statistics of the
    pjit step, and the hand all-reduce of the shard_map step) against the
    JAX package's. The JAX steps run in float64 (``jax.enable_x64``, the
    model's compute dtype float64): this net's float32 gradients are
    ill-conditioned, and the JAX package's own float32 steps on the CPU
    stray from its float64 ones by up to 1.4e-2 (pjit) and 9.9e-2 (the
    single-device step) of a leaf's largest change, beyond the bar. The
    bar, fixed before measuring: with M the largest max-abs change of any
    JAX leaf, a leaf whose JAX change exceeds 1e-4 * M in max-abs is held
    to max-abs(port - jax) <= 1e-3 times its own max-abs change; a leaf at
    or below it is zero to rounding (a conv bias that a BatchNorm follows
    has gradient 0) and its port change is held to <= 1e-4 * M. Both
    ranks' parameters are equal bit for bit."""
    root, outs = two_ranks
    model, variables = jax_init
    init = _flat(variables["params"])
    with jax.enable_x64(True):
        m64 = build_unet(jconfig.ModelConfig(**dict(
            dataclasses.asdict(TINY), compute_dtype="float64")))
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)
        want = _jax_steps((m64, v64), optax.sgd(1.0))
        want = {k: (loss, jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), params))
            for k, (loss, params) in want.items()}
    for kind in ("pjit", "shard_map"):
        jloss, jparams = want[kind]
        np.testing.assert_allclose(outs[0][f"{kind}_sgd"], jloss, rtol=1e-5)
        r0 = torch.load(root / f"{kind}_sgd0.pt")
        r1 = torch.load(root / f"{kind}_sgd1.pt")
        for k in r0:
            assert torch.equal(r0[k], r1[k]), (kind, k)
        net = tunet.UNet(TINY)
        net.load_state_dict(r0)
        got = _flat(to_flax_variables(net)["params"])
        jflat = _flat(jparams, dtype=np.float64)
        dj = {k: jflat[k] - init[k] for k in init}
        dp_ = {k: got[k].astype(np.float64) - init[k] for k in init}
        top = max(float(np.abs(v).max()) for v in dj.values())
        assert top > 0
        held = 0
        for k in dj:
            scale = float(np.abs(dj[k]).max())
            if scale > 1e-4 * top:
                held += 1
                err = float(np.abs(dp_[k] - dj[k]).max())
                assert err <= 1e-3 * scale, (kind, k, err, scale)
            else:
                assert float(np.abs(dp_[k]).max()) <= 1e-4 * top, (kind, k)
        assert held >= len(dj) // 2, (kind, held, len(dj))


def test_two_process_train_model_writes_from_rank_0_only(two_ranks):
    root, outs = two_ranks
    run0, version0, loss0 = outs[0]["train"]
    run1, version1, loss1 = outs[1]["train"]
    assert version0 == 1 and version1 is None
    assert run1 == "process-1" and run0 != run1
    assert loss0 == loss1 and np.isfinite(loss0)
    from robotic_discovery_platform_tpu_torch.training.checkpoint import (
        CheckpointManager,
    )

    state = CheckpointManager(str(root / "ckpt")).restore()
    tunet.UNet(TINY).load_state_dict(state["model"], strict=True)
