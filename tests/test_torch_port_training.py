"""The port's training path against the JAX package's, on the CPU, at a
small size: train-mode BatchNorm, the losses and metrics, one train step,
``train_model`` over two epochs, resume, the data split and order, the
CLI, and the settings the port refuses.

Inputs come from numpy seeds and go into both packages; the port's
network starts from the JAX package's init (converted with
``from_flax_variables``), since the two draw their own inits from
different generators.

Tolerances, fixed before measuring:
- train-mode BatchNorm: outputs rtol 1e-5 (atol 1e-5) in float32 and
  rtol 1e-2 (atol 1e-2, a bfloat16 ulp) in bfloat16; updated running
  statistics rtol 1e-5 (atol 1e-6) in both;
- losses and metrics: rtol 1e-6 (float32 reductions in another order);
- one train step (tiny model, float32, ``conv_impl="interpret"``): loss
  rtol 1e-5; updated parameters and BatchNorm statistics relative L2
  1e-4;
- ``train_model`` over two epochs, and a resumed run: per-epoch train and
  validation losses rtol 1e-4; the split and the batch order equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from robotic_discovery_platform_tpu import tracking as jtracking
from robotic_discovery_platform_tpu.models import losses as jlosses
from robotic_discovery_platform_tpu.models.unet import build_unet, init_unet
from robotic_discovery_platform_tpu.training import data as jdata
from robotic_discovery_platform_tpu.training import trainer as jtrainer
from robotic_discovery_platform_tpu.utils import config as jconfig
from robotic_discovery_platform_tpu_torch import tracking
from robotic_discovery_platform_tpu_torch.models import losses as tlosses
from robotic_discovery_platform_tpu_torch.models import unet as tunet
from robotic_discovery_platform_tpu_torch.models.weights import (
    from_flax_variables,
)
from robotic_discovery_platform_tpu_torch.training import checkpoint
from robotic_discovery_platform_tpu_torch.training import data as tdata
from robotic_discovery_platform_tpu_torch.training import synthetic
from robotic_discovery_platform_tpu_torch.training import trainer
from robotic_discovery_platform_tpu_torch.training.__main__ import main
from robotic_discovery_platform_tpu_torch.utils import config


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread for this module: the suite runs in
    several worker processes at once, and torch's pool of one thread per
    core, oversubscribed, waits on itself at every small op
    (tests/test_torch_port_quant.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _jax_init(model_cfg: config.ModelConfig, seed: int, img: int) -> dict:
    model = build_unet(jconfig.ModelConfig(**dataclasses.asdict(model_cfg)))
    return jax.device_get(jax.jit(lambda key: init_unet(model, key, img))(
        jax.random.key(seed)))


def _port_init_from_jax(monkeypatch, img: int) -> None:
    """Make the port's trainer start from the JAX package's init."""
    def init_model(model_cfg, seed, device):
        net = tunet.UNet(model_cfg)
        net.load_state_dict(from_flax_variables(_jax_init(model_cfg, seed,
                                                          img)))
        return net.to(device)

    monkeypatch.setattr(trainer, "init_model", init_model)


# -- train-mode BatchNorm ------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_batchnorm_matches_flax(dtype):
    rng = np.random.default_rng(5)
    c = 12
    x = (rng.normal(size=(3, 5, 7, c)) * rng.uniform(0.5, 3, c)
         + rng.normal(size=c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    mean0 = rng.normal(0, 0.1, c).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, c).astype(np.float32)

    jdt = jnp.dtype(dtype)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, dtype=jdt)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, upd = bn.apply(variables, jnp.asarray(x).astype(jdt),
                         mutable=["batch_stats"])

    tdt = getattr(torch, dtype)
    tbn = tunet.BatchNorm(c)
    tbn.load_state_dict({"scale": torch.from_numpy(scale),
                         "bias": torch.from_numpy(bias),
                         "mean": torch.from_numpy(mean0),
                         "var": torch.from_numpy(var0)})
    got = tbn(torch.from_numpy(x).to(tdt), train=True)
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    for name in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(tbn, name).numpy(),
            np.asarray(upd["batch_stats"][name]), rtol=1e-5, atol=1e-6)
    # inference leaves the running statistics alone
    before = tbn.mean.clone()
    tbn(torch.from_numpy(x).to(tdt))
    assert torch.equal(tbn.mean, before)


# -- losses and metrics --------------------------------------------------------


@pytest.mark.parametrize("name", ["bce_with_logits", "dice_loss", "bce_dice",
                                  "binary_iou", "mean_iou",
                                  "dice_coefficient", "pixel_accuracy"])
def test_losses_and_metrics_match_jax(name):
    rng = np.random.default_rng(len(name))
    logits = rng.normal(0, 2, size=(3, 16, 16, 1)).astype(np.float32)
    labels = (rng.random((3, 16, 16, 1)) > 0.6).astype(np.float32)
    want = float(getattr(jlosses, name)(jnp.asarray(logits),
                                        jnp.asarray(labels)))
    got = float(getattr(tlosses, name)(torch.from_numpy(logits),
                                       torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("loss", ["bce", "dice", "bce_dice"])
def test_make_loss_fn_matches_jax(loss):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 8, 8, 1)).astype(np.float32)
    labels = (rng.random((2, 8, 8, 1)) > 0.5).astype(np.float32)
    want = float(jlosses.make_loss_fn(loss, 0.3)(jnp.asarray(logits),
                                                 jnp.asarray(labels)))
    got = float(tlosses.make_loss_fn(loss, 0.3)(torch.from_numpy(logits),
                                                torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# -- one train step --------------------------------------------------------------

TINY = config.ModelConfig(base_features=8, compute_dtype="float32",
                          conv_impl="interpret")


@pytest.fixture(scope="module")
def one_step():
    """One step of each package from the JAX init on the same batch: the
    JAX package's ``core_train_step`` with its custom-VJP Pallas convs in
    interpret mode, the port's ``train_step`` on ``conv3x3``.

    32x32 inputs: at 16x16 the deepest BatchNorm reduces over two values
    (B = 2 at 1x1), where a one-ulp change of the input moves the JAX
    package's own gradients by about as much as the 1e-4 bar, so no two
    summation orders could be held to it there."""
    rng = np.random.default_rng(21)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    y = (rng.random((2, 32, 32, 1)) > 0.5).astype(np.float32)
    variables = _jax_init(TINY, 0, 32)

    model = build_unet(jconfig.ModelConfig(**dataclasses.asdict(TINY)))
    tx = optax.adam(1e-3)
    state = jtrainer.TrainState(
        params=variables["params"], opt_state=tx.init(variables["params"]),
        batch_stats=variables["batch_stats"],
        epoch=jnp.asarray(0, jnp.int32),
        best_val_loss=jnp.asarray(jnp.inf, jnp.float32))
    step = jax.jit(jtrainer.core_train_step(model, tx,
                                            jlosses.bce_with_logits))
    jstate, jloss = step(state, jnp.asarray(x), jnp.asarray(y))
    want = {"loss": float(jloss),
            "params": _flat(jax.device_get(jstate.params)),
            "batch_stats": _flat(jax.device_get(jstate.batch_stats))}

    net = tunet.UNet(TINY)
    net.load_state_dict(from_flax_variables(variables))
    opt = trainer.make_optimizer(net, 1e-3)
    loss = trainer.train_step(net, opt, tlosses.bce_with_logits,
                              torch.from_numpy(x), torch.from_numpy(y))
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    got = {"loss": float(loss),
           "params": {k: v for k, v in state.items()
                      if k in want["params"]},
           "batch_stats": {k: v for k, v in state.items()
                           if k in want["batch_stats"]}}
    return got, want


def test_train_step_loss_matches_jax(one_step):
    got, want = one_step
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


@pytest.mark.parametrize("tree", ["params", "batch_stats"])
def test_train_step_updates_match_jax(one_step, tree):
    got, want = one_step
    assert sorted(got[tree]) == sorted(want[tree])
    keys = sorted(want[tree])
    assert _rel_l2(np.concatenate([got[tree][k].ravel() for k in keys]),
                   np.concatenate([want[tree][k].ravel() for k in keys])
                   ) <= 1e-4


def test_train_step_launches_no_kernel_on_the_cpu_and_eval_is_plain():
    """On CPU tensors the training conv runs its plain versions (no
    launches); the eval step runs the inference forward."""
    from robotic_discovery_platform_tpu_torch.ops import conv

    net = tunet.UNet(config.ModelConfig(base_features=4,
                                        compute_dtype="float32"))
    net.init_weights(torch.Generator().manual_seed(0))
    opt = trainer.make_optimizer(net, 1e-3)
    x = torch.rand(2, 16, 16, 3)
    y = (torch.rand(2, 16, 16, 1) > 0.5).float()
    before = (conv.conv3x3_bn_relu.launches,
              conv.conv3x3_grad_weights.launches)
    loss = trainer.train_step(net, opt, tlosses.bce_with_logits, x, y)
    metrics = trainer.eval_step(net, tlosses.bce_with_logits, x, y)
    assert (conv.conv3x3_bn_relu.launches,
            conv.conv3x3_grad_weights.launches) == before
    assert torch.isfinite(loss) and set(metrics) == {"loss", "miou", "dice",
                                                      "accuracy"}
    with torch.no_grad():
        assert torch.equal(metrics["loss"],
                           tlosses.bce_with_logits(net(x), y))


# -- the data pipeline -----------------------------------------------------------


@pytest.mark.parametrize("n,frac,seed", [(20, 0.2, 0), (16, 0.25, 3),
                                         (7, 0.5, 11)])
def test_split_and_batch_order_equal_jax(n, frac, seed):
    assert all(np.array_equal(a, b) for a, b in zip(
        tdata.train_val_split(n, frac, seed),
        jdata.train_val_split(n, frac, seed)))
    xs = np.arange(n, dtype=np.float32)[:, None]
    for shuffle in (True, False):
        port = tdata.Batches(xs, xs, 4, shuffle=shuffle, seed=seed)
        ref = jdata.Batches(xs, xs, 4, shuffle=shuffle, seed=seed)
        for _ in range(3):  # epochs draw successive orders
            got = [bx.ravel().tolist() for bx, _ in port]
            assert got == [bx.ravel().tolist() for bx, _ in ref]


def test_synthetic_arrays_equal_jax():
    from robotic_discovery_platform_tpu.training import synthetic as jsyn

    for a, b in zip(synthetic.generate_arrays(3, 24, 32, seed=4),
                    jsyn.generate_arrays(3, 24, 32, seed=4)):
        assert np.array_equal(a, b)


# -- train_model -------------------------------------------------------------------

TRAIN_MODEL = config.ModelConfig(base_features=8, compute_dtype="float32")


def _cfgs(root, **kw):
    """Both packages' TrainConfig for one run. The learning rate is the
    reference's 1e-4: at 1e-3 Adam's first step, which moves each weight
    by about lr * sign(g), turns the float32 rounding of the JAX
    package's own gradients (farther from a float64 run of them than the
    port's are) into epoch-mean losses beyond the 1e-4 bar."""
    fields = dict(epochs=2, batch_size=4, img_size=32, learning_rate=1e-4,
                  validation_split=0.25, async_checkpointing=True)
    fields.update(kw)
    port = config.TrainConfig(
        tracking_uri=f"file:{root}/port/mlruns",
        checkpoint_dir=f"{root}/port/ckpt", **fields)
    ref = jconfig.TrainConfig(
        tracking_uri=f"file:{root}/jax/mlruns",
        checkpoint_dir=f"{root}/jax/ckpt", **fields)
    return port, ref


def _history(store_uri: str, run_id: str) -> dict:
    store = tracking.store_for(store_uri)
    return {key: [h["value"] for h in store.get_metric_history(run_id, key)]
            for key in ("train_loss", "val_loss")}


@pytest.fixture(scope="module")
def arrays():
    return synthetic.generate_arrays(16, 32, 32, seed=3)


@pytest.fixture(scope="module")
def two_epochs(tmp_path_factory, arrays):
    """Both packages' train_model over two epochs from the JAX init."""
    root = tmp_path_factory.mktemp("two_epochs")
    mp = pytest.MonkeyPatch()
    _port_init_from_jax(mp, 32)
    try:
        port_cfg, ref_cfg = _cfgs(root)
        port = trainer.train_model(port_cfg, TRAIN_MODEL, arrays=arrays,
                                   device="cpu")
        ref = jtrainer.train_model(
            ref_cfg, jconfig.ModelConfig(**dataclasses.asdict(TRAIN_MODEL)),
            arrays=arrays)
    finally:
        mp.undo()
    return port, ref, port_cfg, ref_cfg


def test_train_model_two_epochs_match_jax(two_epochs):
    port, ref, port_cfg, ref_cfg = two_epochs
    got = _history(port_cfg.tracking_uri, port.run_id)
    want = _history(ref_cfg.tracking_uri, ref.run_id)
    assert len(got["train_loss"]) == len(got["val_loss"]) == 2
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    np.testing.assert_allclose(port.best_val_loss, ref.best_val_loss,
                               rtol=1e-4)
    assert port.epochs_run == ref.epochs_run == 2
    assert port.registry_version == ref.registry_version == 1
    assert sorted(port.to_jsonable()) == sorted(ref.to_jsonable())


def test_train_model_tracks_the_reference_surface(two_epochs):
    port, ref, port_cfg, ref_cfg = two_epochs
    store = tracking.store_for(port_cfg.tracking_uri)
    jstore = jtracking.store_for(ref_cfg.tracking_uri)
    assert store.list_experiments() == jstore.list_experiments()
    assert sorted(store.get_params(port.run_id)) == sorted(
        jstore.get_params(ref.run_id))
    assert store.get_run(port.run_id)["status"] == "FINISHED"
    for key in ("train_loss", "val_loss", "val_miou", "val_dice",
                "best_val_loss"):
        assert ([h["step"] for h in store.get_metric_history(port.run_id, key)]
                == [h["step"] for h in jstore.get_metric_history(ref.run_id,
                                                                 key)]), key
    steps = checkpoint.CheckpointManager(port_cfg.checkpoint_dir).steps()
    assert steps == [1, 2]


def _snapshot(net, opt) -> dict:
    return checkpoint.to_host({"model": net.state_dict(),
                               "optimizer": opt.state_dict()})


def _equal_trees(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal_trees, a, b))
    return a == b


def test_resume_restores_what_was_saved(tmp_path, arrays, monkeypatch):
    """One epoch, then resume to three: the resumed run starts from the
    saved parameters, Adam moments, BatchNorm statistics, epoch and best
    loss bit for bit and runs two epochs."""
    saved, first_step = [], []

    class Recording(checkpoint.CheckpointManager):
        def save_async(self, step, state):
            saved.append(checkpoint.to_host(state))
            super().save_async(step, state)

    step = trainer.train_step

    def recording_step(net, opt, *args):
        first_step.append(_snapshot(net, opt))
        return step(net, opt, *args)

    monkeypatch.setattr(trainer, "CheckpointManager", Recording)
    monkeypatch.setattr(trainer, "train_step", recording_step)
    port_cfg, _ = _cfgs(tmp_path, epochs=1)
    trainer.train_model(port_cfg, TRAIN_MODEL, arrays=arrays,
                        register=False, device="cpu")
    assert len(saved) == 1 and saved[0]["epoch"] == 1
    restored = checkpoint.CheckpointManager(port_cfg.checkpoint_dir).restore()
    assert _equal_trees(restored, saved[0])

    n_first = len(first_step)
    port_cfg, _ = _cfgs(tmp_path, epochs=3)
    port = trainer.train_model(port_cfg, TRAIN_MODEL, arrays=arrays,
                               resume=True, register=False, device="cpu")
    assert port.epochs_run == 2
    assert _equal_trees(first_step[n_first],
                        {"model": saved[0]["model"],
                         "optimizer": saved[0]["optimizer"]})
    assert [s["epoch"] for s in saved] == [1, 2, 3]
    assert saved[1]["best_val_loss"] <= saved[0]["best_val_loss"]


def _port_checkpoint_from_jax(ref_cfg, directory, jmodel) -> None:
    """The JAX package's latest checkpoint, rewritten as the port's: the
    same parameters, BatchNorm statistics, Adam moments and count, epoch,
    best loss and best-so-far variables."""
    from robotic_discovery_platform_tpu.training.checkpoint import (
        CheckpointManager as JaxCheckpointManager,
    )

    tx = optax.adam(ref_cfg.learning_rate)
    state = jtrainer.create_state(build_unet(jmodel), tx,
                                  jax.random.key(ref_cfg.seed),
                                  ref_cfg.img_size)
    template = jax.device_get({"state": state, "best_params": state.params,
                               "best_stats": state.batch_stats})
    jckpt = JaxCheckpointManager(ref_cfg.checkpoint_dir)
    restored = jax.device_get(jckpt.restore(template))
    jckpt.close()
    jstate = restored["state"]
    adam = jstate.opt_state[0]

    net = tunet.UNet(TRAIN_MODEL)
    net.load_state_dict(from_flax_variables(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    opt = trainer.make_optimizer(net, ref_cfg.learning_rate)
    mu, nu = _flat(adam.mu), _flat(adam.nu)
    for name, param in net.named_parameters():
        opt.state[param] = {
            "step": torch.tensor(float(adam.count)),
            "exp_avg": torch.from_numpy(mu[name].copy()),
            "exp_avg_sq": torch.from_numpy(nu[name].copy())}
    best = from_flax_variables({"params": restored["best_params"],
                                "batch_stats": restored["best_stats"]})
    checkpoint.CheckpointManager(directory).save(int(jstate.epoch), {
        "model": net.state_dict(), "optimizer": opt.state_dict(),
        "epoch": int(jstate.epoch),
        "best_val_loss": float(jstate.best_val_loss), "best": best})


def test_resume_from_the_same_state_matches_jax(tmp_path, arrays):
    """The JAX package trains one epoch; both packages resume from that
    checkpoint (the port's copy of it, which like the JAX package's
    carries no epoch order state) to three epochs. Both run two epochs,
    re-seed the batch order from the seed as a fresh run does, and their
    losses agree."""
    jmodel = jconfig.ModelConfig(**dataclasses.asdict(TRAIN_MODEL))
    port_cfg, ref_cfg = _cfgs(tmp_path, epochs=1)
    jtrainer.train_model(ref_cfg, jmodel, arrays=arrays, register=False)
    _port_checkpoint_from_jax(ref_cfg, port_cfg.checkpoint_dir, jmodel)

    port_cfg, ref_cfg = _cfgs(tmp_path, epochs=3)
    port = trainer.train_model(port_cfg, TRAIN_MODEL, arrays=arrays,
                               resume=True, register=False, device="cpu")
    ref = jtrainer.train_model(ref_cfg, jmodel, arrays=arrays, resume=True,
                               register=False)
    assert port.epochs_run == ref.epochs_run == 2
    got = _history(port_cfg.tracking_uri, port.run_id)
    want = _history(ref_cfg.tracking_uri, ref.run_id)
    for key in ("train_loss", "val_loss"):
        assert len(got[key]) == 2
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)


@pytest.mark.parametrize("async_save", [True, False])
def test_checkpoint_round_trip_is_bitwise(tmp_path, async_save):
    """A trainer payload after one step (parameters, Adam moments and
    step, BatchNorm statistics, epoch, best loss) restores bit for bit;
    retention keeps the newest ``keep``; the async save may race the live
    tensors' next update without tearing."""
    net = tunet.UNet(config.ModelConfig(base_features=4,
                                        compute_dtype="float32"))
    net.init_weights(torch.Generator().manual_seed(1))
    opt = trainer.make_optimizer(net, 1e-3)
    x, y = torch.rand(2, 16, 16, 3), (torch.rand(2, 16, 16, 1) > 0.5).float()
    trainer.train_step(net, opt, tlosses.bce_with_logits, x, y)
    mgr = checkpoint.CheckpointManager(tmp_path / "ckpt", keep=2)
    want = []
    for step in (1, 2, 3):
        payload = {"model": net.state_dict(), "optimizer": opt.state_dict(),
                   "epoch": step, "best_val_loss": 0.5 / step,
                   "best": net.state_dict()}
        want.append(checkpoint.to_host(payload))
        (mgr.save_async if async_save else mgr.save)(step, payload)
        trainer.train_step(net, opt, tlosses.bce_with_logits, x, y)
    mgr.close()
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    assert _equal_trees(mgr.restore(), want[2])
    assert _equal_trees(mgr.restore(2), want[1])


def test_train_model_registers_the_best_variables(two_epochs):
    """The registered artifact holds the best epoch's variables: the
    checkpoint's best-so-far state, bit for bit."""
    port, _, port_cfg, _ = two_epochs
    _, net = tracking.load_model("models:/Actuator-Segmenter/1",
                                 store=tracking.store_for(
                                     port_cfg.tracking_uri), device="cpu")
    best = checkpoint.CheckpointManager(port_cfg.checkpoint_dir).restore()
    assert _equal_trees(net.state_dict(), best["best"])
    assert best["best_val_loss"] == port.best_val_loss


# -- inputs, the CLI and what the port refuses ---------------------------------


def test_integer_inputs_normalized_and_other_codings_refused(tmp_path):
    imgs, masks = synthetic.generate_arrays(8, 16, 16, seed=3)
    xs, ys = trainer.normalize_arrays(imgs, masks)
    assert xs.dtype == ys.dtype == np.float32
    assert xs.max() <= 1.0 and set(np.unique(ys)) <= {0.0, 1.0}
    _, ys01 = trainer.normalize_arrays(imgs, masks // 255)
    assert np.array_equal(ys01, ys)
    cfg, _ = _cfgs(tmp_path, epochs=1, img_size=16)
    with pytest.raises(ValueError, match="integer masks"):
        trainer.train_model(cfg, TRAIN_MODEL, arrays=(imgs, masks // 255 * 2),
                            register=False, device="cpu")
    with pytest.raises(ValueError, match="validation split"):
        trainer.train_model(cfg, TRAIN_MODEL, arrays=(imgs[:1], masks[:1]),
                            register=False, device="cpu")


def test_cli_trains_from_a_file_dataset(tmp_path, capsys):
    import json

    synthetic.generate_dataset(tmp_path / "ds", n=5, h=40, w=48, seed=2)
    rc = main(["--device", "cpu", "--train.epochs", "1",
               "--train.img_size", "16", "--train.batch_size", "2",
               "--train.dataset_dir", str(tmp_path / "ds"),
               "--train.tracking_uri", f"file:{tmp_path}/mlruns",
               "--train.checkpoint_dir", str(tmp_path / "ckpt"),
               "--train.loader_workers", "1",
               "--model.base_features", "4", "--no-register"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["epochs_run"] == 1 and out["registry_version"] is None
    assert np.isfinite(out["best_val_loss"])
    assert main(["--device", "cpu", "--train.dataset_dir",
                 str(tmp_path / "none")]) == 2


@pytest.mark.parametrize("case", ["epoch_mode_scan", "epoch_mode_unknown",
                                  "mesh_argument", "mesh_flag",
                                  "tracking_http", "tracking_mlflow",
                                  "checkpoint_every_zero", "no_card",
                                  "supervisor", "retraining_workflow"])
def test_training_refuses_what_the_slice_lacks(case, tmp_path, monkeypatch):
    cfg, _ = _cfgs(tmp_path, epochs=1, img_size=16)
    arrays = synthetic.generate_arrays(4, 16, 16, seed=0)
    kw = dict(arrays=arrays, register=False, device="cpu")
    if case == "epoch_mode_scan":
        # the whole-epoch scan is ported: one epoch of it on the CPU
        result = trainer.train_model(
            dataclasses.replace(cfg, epoch_mode="scan"), TRAIN_MODEL, **kw)
        assert result.epochs_run == 1
        assert np.isfinite(result.best_val_loss)
    elif case == "epoch_mode_unknown":
        with pytest.raises(ValueError, match="epoch_mode"):
            trainer.train_model(dataclasses.replace(cfg, epoch_mode="x"),
                                TRAIN_MODEL, **kw)
    elif case == "mesh_argument":
        # the mesh trainer is ported (tests/test_torch_port_parallel.py,
        # tests/test_torch_port_tp_spatial.py): a mesh needs one rank of a
        # process group per position, on every axis
        from robotic_discovery_platform_tpu_torch.parallel import mesh
        from robotic_discovery_platform_tpu_torch.utils.config import (
            MeshConfig,
        )

        cpus = [torch.device("cpu")] * 2
        with pytest.raises(ValueError, match="world size"):
            trainer.train_model(cfg, TRAIN_MODEL, mesh=mesh.make_mesh(
                MeshConfig(data=1, model=2), devices=cpus), **kw)
        with pytest.raises(ValueError, match="world size"):
            trainer.train_model(cfg, TRAIN_MODEL, mesh=mesh.make_mesh(
                MeshConfig(data=2), devices=cpus), **kw)
    elif case == "mesh_flag":
        # --mesh.* builds the mesh over --device's devices: one CPU
        with pytest.raises(ValueError, match="mesh 2x1x1 != 1 available"):
            main(["--device", "cpu", "--mesh.data", "2"])
    elif case == "tracking_http":
        # ported: an http:// URI reaches the REST store, and a run trains
        # against an MLflow server (tests/fake_mlflow_server.py)
        from fake_mlflow_server import FakeMlflowServer

        from robotic_discovery_platform_tpu_torch.tracking import api
        from robotic_discovery_platform_tpu_torch.tracking.rest_backend import (
            RestMlflowStore,
        )

        prev = tracking.get_tracking_uri()
        try:
            with FakeMlflowServer() as uri:
                assert isinstance(tracking.store_for(uri), RestMlflowStore)
                result = trainer.train_model(
                    dataclasses.replace(cfg, tracking_uri=uri), TRAIN_MODEL,
                    **kw)
                assert isinstance(api._store(), RestMlflowStore)
                history = tracking.get_metric_history(result.run_id,
                                                      "train_loss")
                assert [h["step"] for h in history] == [0]
        finally:
            tracking.set_tracking_uri(prev)
    elif case == "tracking_mlflow":
        # the mlflow client is not used: the JAX package's ImportError for
        # a missing client, from the URI and from train_model
        uri = "mlflow+file:/tmp/x"
        with pytest.raises(ImportError, match="needs the 'mlflow' extra"):
            tracking.set_tracking_uri(uri)
        with pytest.raises(ImportError, match="needs the 'mlflow' extra"):
            trainer.train_model(dataclasses.replace(cfg, tracking_uri=uri),
                                TRAIN_MODEL, **kw)
        with pytest.raises(ImportError, match="needs the 'mlflow' extra"):
            tracking.store_for("databricks://profile")
    elif case == "supervisor":
        # ported (tests/test_torch_port_supervisor.py): a checkpoint that
        # never landed (its temp directory) does not count as training
        # started, so a deterministic startup error still fails fast
        from robotic_discovery_platform_tpu_torch.training import supervisor

        ckpt = tmp_path / "sup"
        (ckpt / ".1.tmp").mkdir(parents=True)
        (ckpt / ".1.tmp" / checkpoint.STATE_FILE).write_bytes(b"")
        (ckpt / "2").mkdir()  # renamed, but holds no state file
        assert not supervisor._has_completed_step(ckpt)
        (ckpt / "2" / checkpoint.STATE_FILE).write_bytes(b"")
        assert supervisor._completed_steps(ckpt) == [2]
    elif case == "retraining_workflow":
        # ported (tests/test_torch_port_retraining.py), with the mesh
        # trainer under it: a model axis with no process group of its size
        # is refused, and the failure is the cycle's result
        from robotic_discovery_platform_tpu_torch.parallel import mesh
        from robotic_discovery_platform_tpu_torch.utils.config import (
            MeshConfig,
        )
        from robotic_discovery_platform_tpu_torch.workflows import retraining

        tp = mesh.make_mesh(MeshConfig(data=1, model=2),
                            devices=[torch.device("cpu")] * 2)
        res = retraining.run_retraining_pipeline(
            cfg, TRAIN_MODEL, mesh=tp, arrays=arrays, device="cpu")
        assert not res.succeeded and "world size" in res.message
    elif case == "checkpoint_every_zero":
        with pytest.raises(ValueError, match="checkpoint_every"):
            trainer.train_model(dataclasses.replace(cfg, checkpoint_every=0),
                                TRAIN_MODEL, **kw)
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trainer.train_model(cfg, TRAIN_MODEL, arrays=arrays,
                                register=False)


@pytest.mark.parametrize("name", ["TrainConfig", "MeshConfig", "ModelConfig"])
def test_config_sections_match_jax(name):
    """The port's sections carry the JAX package's names and defaults (the
    server's registry fields too)."""
    assert (dataclasses.asdict(getattr(config, name)())
            == dataclasses.asdict(getattr(jconfig, name)()))
    port, ref = config.ServerConfig(), jconfig.ServerConfig()
    for field in ("tracking_uri", "model_name", "model_alias"):
        assert getattr(port, field) == getattr(ref, field)
