"""The port's tensor parallelism over "model" and spatial sharding over
"spatial" (``parallel/collectives.py``, ``parallel/sharded.py``, the
model and spatial axes of ``parallel/dp.py`` and the mesh trainer)
against the JAX package, on the CPU.

The meshes are those of the JAX package's bars (tests/test_parallel.py:
100-166, tests/test_multihost.py:141-161), at their sizes: base_features
8, 32x32 images, bilinear, batch norm, bce, a global batch of 8; and
three more paths of the split step at those sizes: a spatial mesh on
group norm, the full mesh on the bce + dice loss (whose per-sample sums
are taken over the spatial group), and a model mesh on the transposed-conv
decoder (``bilinear=False``) whose ``Up_0.ConvTranspose_0`` kernel is
split. The port's
ranks are spawned ``gloo`` processes (``file://`` init under a temporary
directory, ``OMP_NUM_THREADS=1``, every rank collected before anything is
asserted, a timeout on each launch). Weights start from the JAX init,
carried across by ``models/weights.from_flax_variables``, and each mesh
step is held against the JAX package's single-device step.

Tolerances, fixed before measuring:
- one Adam step at lr 1e-3: the loss at rtol 1e-5 and every parameter at
  atol 5e-3 (the JAX tests' bars);
- one SGD step at lr 1, the port's in float64 (``compute_dtype=
  "float64"``, float64 parameters), against the JAX single-device step
  run in float64, by the gradient rule of tests/test_torch_port_parallel.py
  (``test_two_process_gradients_match_jax``): a leaf whose JAX change
  exceeds 1e-4 of the largest leaf's max-abs change is held to max-abs
  error <= 1e-3 of its own max-abs change, the others to <= 1e-4 of the
  largest. The port's float32 single-device step misses that rule on
  this init and batch (2.1e-3 of ``Up_3.DoubleConv_0.Conv_0.kernel``'s
  change against its float64 step), as the JAX package's float32 steps
  do (up to 9.9e-2, tests/test_torch_port_parallel.py): in float32 a
  pre-activation near a ReLU's kink lands on the other side. So the rule
  is held in float64 on both sides, where what it measures is the split
  step's adjoints;
- under a spatial axis, the eval metrics at atol 1e-4 of the JAX
  single-device eval (the JAX bar), after the float64 SGD step of both:
  after one float32 Adam step the port's single-device group-norm net
  already classifies 5 of the 8192 pixels otherwise than the JAX one
  (accuracy 0.51624 against 0.51563; Adam moves a parameter whose
  gradient is near zero by up to 2 lr whichever way float32 rounds it);
- every rank returns the same loss, bit for bit;
- the primitives' backward against autograd of the unsharded function:
  atol 1e-6 in float64.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import robotic_discovery_platform_tpu as jpkg
import robotic_discovery_platform_tpu_torch as tpkg
from robotic_discovery_platform_tpu.models import losses as jlosses
from robotic_discovery_platform_tpu.models.unet import build_unet, init_unet
from robotic_discovery_platform_tpu.training import trainer as jtrainer
from robotic_discovery_platform_tpu.utils import config as jconfig
from robotic_discovery_platform_tpu_torch.models import unet as tunet
from robotic_discovery_platform_tpu_torch.models.weights import (
    from_flax_variables,
)
from robotic_discovery_platform_tpu_torch.parallel import collectives
from robotic_discovery_platform_tpu_torch.training import synthetic
from robotic_discovery_platform_tpu_torch.training.checkpoint import (
    CheckpointManager,
)
from robotic_discovery_platform_tpu_torch.utils.config import ModelConfig

REPO = Path(__file__).resolve().parent.parent
TINY = ModelConfig(base_features=8, compute_dtype="float32",
                   conv_impl="flax")
#: the nets' config fields beyond TINY's
VARIANTS = {"batch": {}, "group": {"norm": "group"},
            "convt": {"bilinear": False}}
CONFIGS = {v: dataclasses.replace(TINY, **f) for v, f in VARIANTS.items()}
#: name -> ((data, spatial, model), tp_min_channels, variant, loss): the
#: JAX bars' meshes (tests/test_parallel.py) and three more paths
#: (module docstring)
MESHES = {
    "tp": ((4, 1, 2), 64, "batch", "bce"),
    "spatial": ((2, 4, 1), 256, "batch", "bce"),
    "full": ((2, 2, 2), 64, "batch", "bce"),
    "spatial_group": ((2, 4, 1), 256, "group", "bce"),
    "full_bce_dice": ((2, 2, 2), 64, "batch", "bce_dice"),
    "tp_convt": ((4, 1, 2), 64, "convt", "bce"),
}
#: the (variant, loss) pairs the meshes train
REFERENCES = sorted({(v, loss) for _, _, v, loss in MESHES.values()})
LAUNCH_TIMEOUT_S = 300


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
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


def _jax_model(cfg: ModelConfig, dtype=None):
    fields = dataclasses.asdict(cfg)
    if dtype is not None:
        fields["compute_dtype"] = dtype
    return build_unet(jconfig.ModelConfig(**fields))


@pytest.fixture(scope="module")
def jax_inits():
    """The JAX init of each variant's net (key 0, as the JAX tests)."""
    out = {}
    for variant, cfg in CONFIGS.items():
        model = _jax_model(cfg)
        out[variant] = jax.device_get(jax.jit(
            lambda k, model=model: init_unet(model, k, 32))(
                jax.random.key(0)))
    return out


def _jax_step(cfg, variables, tx, loss, dtype=None):
    """The JAX package's single-device train step on ``loss`` and eval
    after it."""
    model = _jax_model(cfg, dtype)
    if dtype == "float64":
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), variables)
    state = jtrainer.TrainState(
        params=variables["params"], opt_state=tx.init(variables["params"]),
        batch_stats=variables.get("batch_stats", {}),
        epoch=jnp.asarray(0, jnp.int32),
        best_val_loss=jnp.asarray(jnp.inf, jnp.float32))
    x, y = (jnp.asarray(a) for a in _batch(8))
    loss_fn = jlosses.make_loss_fn(loss)
    s1, loss = jax.jit(jtrainer.core_train_step(model, tx, loss_fn))(
        state, x, y)
    metrics = jax.jit(jtrainer.core_eval_step(model, loss_fn))(s1, x, y)
    return (float(loss), jax.device_get(s1.params),
            {k: float(v) for k, v in metrics.items()})


def _flat(tree: dict, prefix: str = "", dtype=np.float32) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}.", dtype))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, dtype)
    return out


def _port_params(path, cfg, dtype=np.float32) -> dict:
    """A saved state dict's parameters under the JAX tree's paths (the
    port's names are those paths joined by dots), at its own precision."""
    state = torch.load(path)
    tunet.UNet(cfg).load_state_dict(state, strict=True)
    return {n: state[n].numpy().astype(dtype)
            for n, _ in tunet.UNet(cfg).named_parameters()}


def _gradient_bar(init: dict, want: dict, got: dict, tag: str) -> None:
    """tests/test_torch_port_parallel.py's rule on one SGD step at lr 1
    (module docstring)."""
    dj = {k: want[k] - init[k] for k in init}
    dp_ = {k: got[k].astype(np.float64) - init[k] for k in init}
    top = max(float(np.abs(v).max()) for v in dj.values())
    assert top > 0
    held = 0
    for k in dj:
        scale = float(np.abs(dj[k]).max())
        if scale > 1e-4 * top:
            held += 1
            err = float(np.abs(dp_[k] - dj[k]).max())
            assert err <= 1e-3 * scale, (tag, k, err, scale)
        else:
            assert float(np.abs(dp_[k]).max()) <= 1e-4 * top, (tag, k)
    assert held >= len(dj) // 2, (tag, held, len(dj))


# -- spawned gloo ranks ---------------------------------------------------------

STEPS_WORKER = textwrap.dedent('''
    import dataclasses, json, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    from robotic_discovery_platform_tpu_torch.models import losses, unet
    from robotic_discovery_platform_tpu_torch.parallel import dp, mesh as M
    from robotic_discovery_platform_tpu_torch.training import trainer
    from robotic_discovery_platform_tpu_torch.utils.config import (
        MeshConfig, ModelConfig)
    rank, root = int(sys.argv[1]), sys.argv[2]
    meshes, variants = json.loads(sys.argv[3]), json.loads(sys.argv[4])
    dist.init_process_group("gloo", init_method=f"file://{root}/pg",
                            world_size=8, rank=rank)
    try:
        data = np.load(f"{root}/batch.npz")
        x, y = data["x"], data["y"]
        out = {}
        for name, ((d, s, m), tp_min, variant, loss_name) in meshes.items():
            cfg = ModelConfig(base_features=8, compute_dtype="float32",
                              conv_impl="flax", **variants[variant])
            init = torch.load(f"{root}/init_{variant}.pt")
            mesh = M.make_mesh(MeshConfig(data=d, spatial=s, model=m),
                               devices=[torch.device("cpu")] * 8)
            for rule in ("adam", "sgd"):
                if rule == "adam":
                    net = unet.UNet(cfg)
                else:  # in float64, held against the JAX float64 step
                    net = unet.UNet(dataclasses.replace(
                        cfg, compute_dtype="float64")).double()
                net.load_state_dict(init)
                opt = (trainer.make_optimizer(net, 1e-3) if rule == "adam"
                       else torch.optim.SGD(net.parameters(), lr=1.0))
                train, evals, state = dp.parallelize_training(
                    mesh, net, opt, losses.make_loss_fn(loss_name),
                    tp_min_channels=tp_min)
                state, loss = train(state, x, y)
                full = dp.full_state_dict(state)
                key = f"{name}_{rule}"
                out[key] = float(loss)
                out[key + "_metrics"] = {
                    k: float(v) for k, v in evals(state, x, y).items()}
                if rule == "adam":
                    out[key + "_coord"] = list(state.groups.coord)
                    torch.save({n: dict(state.net.named_parameters())[n]
                                .detach() for n in state.sharded},
                               f"{root}/{key}_slices{rank}.pt")
                    opt_full = dp.full_optimizer_state(state)
                    order = [n for n, _ in state.net.named_parameters()]
                    out[key + "_moments"] = all(
                        tuple(opt_full["state"][i]["exp_avg"].shape)
                        == tuple(full[n].shape) for i, n in enumerate(order))
                if rank == 0:
                    torch.save(full, f"{root}/{key}.pt")
        print(json.dumps(out))
    finally:
        dist.destroy_process_group()
''')


def _launch(worker: str, n: int, root: Path, *args) -> list:
    """``n`` ranks of ``worker``, all collected before anything is
    asserted; each rank's last stdout line as JSON."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, "-c", worker, str(r),
                               str(root), *args], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=LAUNCH_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r}: {err[-2000:]}"
              for r, (rc, _, err) in enumerate(outs) if rc != 0]
    assert not failed, "\n".join(failed)
    return [json.loads(o.strip().splitlines()[-1]) for _, o, _ in outs]


@pytest.fixture(scope="module")
def eight_ranks(jax_inits, tmp_path_factory):
    """One 8-rank launch running every mesh of ``MESHES`` on the same
    ranks."""
    root = tmp_path_factory.mktemp("tp_spatial8")
    x, y = _batch(8)
    np.savez(root / "batch.npz", x=x, y=y)
    for variant, variables in jax_inits.items():
        torch.save(from_flax_variables(variables),
                   root / f"init_{variant}.pt")
    return root, _launch(STEPS_WORKER, 8, root, json.dumps(MESHES),
                         json.dumps(VARIANTS))


@pytest.fixture(scope="module")
def jax_reference(jax_inits):
    """The JAX single-device steps of each (variant, loss): Adam in
    float32, SGD at lr 1 in float64."""
    out = {}
    for variant, loss in REFERENCES:
        cfg, init = CONFIGS[variant], jax_inits[variant]
        adam = _jax_step(cfg, init, optax.adam(1e-3), loss)
        with jax.enable_x64(True):
            sgd = _jax_step(cfg, init, optax.sgd(1.0), loss, "float64")
            sgd = (sgd[0], jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), sgd[1]), sgd[2])
        out[variant, loss] = {"adam": adam, "sgd": sgd}
    return out


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_adam_step_matches_jax_single_device(name, eight_ranks,
                                                  jax_reference):
    root, outs = eight_ranks
    _, _, variant, loss = MESHES[name]
    jloss, jparams, _ = jax_reference[variant, loss]["adam"]
    losses_ = {o[f"{name}_adam"] for o in outs}
    assert len(losses_) == 1, losses_  # every rank the same, bit for bit
    np.testing.assert_allclose(outs[0][f"{name}_adam"], jloss, rtol=1e-5)
    got = _port_params(root / f"{name}_adam.pt", CONFIGS[variant])
    flat = _flat(jparams)
    assert sorted(got) == sorted(flat)
    for k in flat:
        np.testing.assert_allclose(got[k], flat[k], atol=5e-3,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_sgd_gradients_match_jax_float64(name, eight_ranks,
                                              jax_reference, jax_inits):
    root, outs = eight_ranks
    _, _, variant, loss = MESHES[name]
    jloss, jparams, _ = jax_reference[variant, loss]["sgd"]
    assert len({o[f"{name}_sgd"] for o in outs}) == 1
    np.testing.assert_allclose(outs[0][f"{name}_sgd"], jloss, rtol=1e-5)
    got = _port_params(root / f"{name}_sgd.pt", CONFIGS[variant],
                       np.float64)
    _gradient_bar(_flat(jax_inits[variant]["params"], dtype=np.float64),
                  _flat(jparams, dtype=np.float64), got, name)


@pytest.mark.parametrize("name", [n for n, (shape, *_) in MESHES.items()
                                  if shape[1] > 1])
def test_spatial_eval_metrics_match_jax(name, eight_ranks, jax_reference):
    """The eval after the float64 SGD step, against the JAX float64 step's
    (module docstring)."""
    _, outs = eight_ranks
    _, _, variant, loss = MESHES[name]
    _, _, want = jax_reference[variant, loss]["sgd"]
    for o in outs:
        got = o[f"{name}_sgd_metrics"]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", [n for n, (shape, *_) in MESHES.items()
                                  if shape[2] > 1])
def test_model_axis_holds_kernel_slices(name, eight_ranks):
    """Under model = 2 each split kernel holds Cout / 2 channels on its
    rank, the slices of the two model ranks put together are the full
    tensor, and Adam's moments are gathered to full shape. The
    transposed-conv decoder splits its widest transposed conv too."""
    root, outs = eight_ranks
    (d, s, m), tp_min, variant, _ = MESHES[name]
    full = torch.load(root / f"{name}_adam.pt")
    slices = [torch.load(root / f"{name}_adam_slices{r}.pt")
              for r in range(8)]
    names = set(slices[0])
    assert names and all(set(sl) == names for sl in slices)
    for n in names:
        assert n.endswith(".kernel") and full[n].shape[-1] >= tp_min
    assert ("Up_0.ConvTranspose_0.kernel" in names) == (variant == "convt")
    for r, o in enumerate(outs):
        assert o[f"{name}_adam_moments"]
        assert tuple(o[f"{name}_adam_coord"]) == tuple(
            int(i) for i in np.unravel_index(r, (d, s, m)))
        for n in names:
            assert slices[r][n].shape[-1] == full[n].shape[-1] // m
    for r in range(0, 8, m):  # each model group: ranks r .. r + m - 1
        for n in names:
            torch.testing.assert_close(
                torch.cat([slices[r + k][n] for k in range(m)], -1), full[n],
                rtol=0, atol=0)


RESUME_WORKER = textwrap.dedent('''
    import json, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    from robotic_discovery_platform_tpu_torch.parallel import mesh as M
    from robotic_discovery_platform_tpu_torch.training import trainer
    from robotic_discovery_platform_tpu_torch.utils.config import (
        MeshConfig, ModelConfig, TrainConfig)
    rank, root = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=f"file://{root}/pg",
                            world_size=4, rank=rank)
    try:
        data = np.load(f"{root}/arrays.npz")
        arrays = (data["imgs"], data["masks"])
        mesh = M.make_mesh(MeshConfig(data=2, model=2),
                           devices=[torch.device("cpu")] * 4)
        model = ModelConfig(base_features=8, compute_dtype="float32")
        out = {}
        for run, epochs in ((1, 1), (2, 2)):
            cfg = TrainConfig(epochs=epochs, batch_size=4, img_size=32,
                              tracking_uri=f"file:{root}/mlruns",
                              checkpoint_dir=f"{root}/ckpt",
                              validation_split=0.25,
                              async_checkpointing=False, tp_min_channels=64)
            res = trainer.train_model(cfg, model, arrays=arrays,
                                      resume=run == 2, mesh=mesh,
                                      register=True, device="cpu")
            out[f"v{run}"] = res.registry_version
            out[f"best{run}"] = float(res.best_val_loss)
            out[f"epochs_run_{run}"] = res.epochs_run
            out["val_miou"] = float(res.final_metrics["miou"])
        print(json.dumps(out))
    finally:
        dist.destroy_process_group()
''')


def test_four_process_tp_resume(tmp_path):
    """dp 2 x tp 2 (tests/test_multihost.py's resume case): a 1-epoch run,
    then a resumed 2-epoch run that trains exactly one more epoch; rank 0
    alone registers versions 1 and 2; the resumed best is no worse; every
    tensor of the checkpoint is full-shaped and loads into a
    single-device net."""
    imgs, masks = synthetic.generate_arrays(16, 32, 32, seed=1)
    np.savez(tmp_path / "arrays.npz", imgs=imgs, masks=masks)
    outs = _launch(RESUME_WORKER, 4, tmp_path)
    assert outs[0]["v1"] == 1 and outs[0]["v2"] == 2
    for o in outs[1:]:
        assert o["v1"] is None and o["v2"] is None
    for o in outs:
        assert o["epochs_run_1"] == 1 and o["epochs_run_2"] == 1
        assert np.isfinite(o["best2"]) and o["best2"] <= o["best1"]
        assert o["best2"] == outs[0]["best2"]
        assert o["val_miou"] == outs[0]["val_miou"]
    state = CheckpointManager(str(tmp_path / "ckpt")).restore()
    assert int(state["epoch"]) == 2
    net = tunet.UNet(TINY)
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    for part in ("model", "best"):
        assert {k: tuple(v.shape) for k, v in state[part].items()} == shapes
        net.load_state_dict(state[part], strict=True)
    params = [tuple(p.shape) for p in net.parameters()]
    moments = state["optimizer"]["state"]
    assert [tuple(moments[i]["exp_avg"].shape)
            for i in range(len(params))] == params


def test_cli_trains_over_a_spatial_and_model_mesh(tmp_path):
    """``python -m robotic_discovery_platform_tpu_torch.training
    --mesh.spatial 2 --mesh.model 2`` as four ranks of a launcher's process
    group (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), on a
    file dataset in the default bfloat16 compute: every rank trains the
    same epoch and rank 0 alone writes the checkpoint."""
    import socket

    synthetic.generate_dataset(tmp_path / "ds", n=8, h=40, w=48, seed=2)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    args = [sys.executable, "-m", "robotic_discovery_platform_tpu_torch."
            "training", "--device", "cpu", "--mesh.spatial", "2",
            "--mesh.model", "2", "--train.epochs", "1",
            "--train.img_size", "16", "--train.batch_size", "2",
            "--train.dataset_dir", str(tmp_path / "ds"),
            "--train.tracking_uri", f"file:{tmp_path}/mlruns",
            "--train.checkpoint_dir", str(tmp_path / "ckpt"),
            "--train.loader_workers", "1", "--train.tp_min_channels", "8",
            "--model.base_features", "4", "--no-register"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               WORLD_SIZE="4", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    procs = [subprocess.Popen(args, cwd=REPO, env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=LAUNCH_TIMEOUT_S))
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r}: {err[-2000:]}" for r, (p, (_, err))
              in enumerate(zip(procs, outs)) if p.returncode != 0]
    assert not failed, "\n".join(failed)
    res = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert all(r["epochs_run"] == 1 for r in res)
    assert len({r["best_val_loss"] for r in res}) == 1
    assert np.isfinite(res[0]["best_val_loss"])
    state = CheckpointManager(str(tmp_path / "ckpt")).restore()
    net = tunet.UNet(ModelConfig(base_features=4))
    net.load_state_dict(state["model"], strict=True)


# -- the primitives, in one process ---------------------------------------------


class _ThreadGroup:
    """``n`` ranks as threads of this process: the collectives' two
    transports (all-reduce, all-gather) over a barrier."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=30)
        self.slots = [None] * n
        self.local = threading.local()

    def exchange(self, t: torch.Tensor) -> list:
        self.slots[self.local.rank] = t.detach().clone()
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out

    def run(self, fn) -> list:
        """``fn(rank)`` on every rank's thread; the results in rank
        order."""
        results, errors = [None] * self.n, []

        def body(r):
            self.local.rank = r
            try:
                results[r] = fn(r)
            except BaseException as exc:  # re-raised in the test's thread
                errors.append(exc)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        if errors:
            raise errors[0]
        return results


@pytest.fixture
def thread_group(monkeypatch):
    group = _ThreadGroup(4)
    monkeypatch.setattr(collectives, "size", lambda g: 1 if g is None
                        else g.n)
    monkeypatch.setattr(collectives, "index", lambda g: 0 if g is None
                        else g.local.rank)

    def all_gather(t, g, dim):
        return torch.cat(g.exchange(t), dim)

    def all_reduce_(t, g):
        parts = g.exchange(t)
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        return t.copy_(total)

    monkeypatch.setattr(collectives, "all_gather", all_gather)
    monkeypatch.setattr(collectives, "all_reduce_", all_reduce_)
    return group


def _sharded_grads(group, pieces, fn, seeds):
    """Each rank's ``fn(piece, group)`` backpropagated from its seed;
    the gradients of the pieces in rank order."""
    def rank(r):
        x = pieces[r].clone().requires_grad_(True)
        fn(x, group).backward(seeds[r])
        return x.grad

    return group.run(rank)


def _rng_tensor(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape))


@pytest.mark.parametrize("rows", [1, 3])
def test_halo_rows_backward_is_its_adjoint(thread_group, rows):
    """H split in 4 (1 and 3 rows a rank): each rank's padded block is
    rows [s*h - 1, s*h + h] of the zero-padded map; the pieces' gradients
    equal autograd's through the unsharded pad and slices."""
    rng = np.random.default_rng(0)
    n = thread_group.n
    x = _rng_tensor(rng, 2, n * rows, 3, 2)
    seeds = [_rng_tensor(rng, 2, rows + 2, 3, 2) for _ in range(n)]
    ref = x.clone().requires_grad_(True)
    padded = torch.nn.functional.pad(ref, (0, 0, 0, 0, 1, 1))
    total = sum((padded[:, s * rows:s * rows + rows + 2] * seeds[s]).sum()
                for s in range(n))
    total.backward()
    pieces = list(x.split(rows, dim=1))
    fwd = thread_group.run(lambda r: collectives.halo_rows(
        pieces[r], thread_group))
    for s in range(n):
        torch.testing.assert_close(fwd[s], padded[:, s * rows:
                                                  s * rows + rows + 2]
                                   .detach(), rtol=0, atol=0)
    got = _sharded_grads(thread_group, pieces, collectives.halo_rows, seeds)
    torch.testing.assert_close(torch.cat(got, 1), ref.grad, rtol=0,
                               atol=1e-6)


def test_gather_rows_backward_is_a_reduce_scatter(thread_group):
    """Each rank uses the gathered map with its own seed: the unsharded
    function is the map used four times, so a piece's gradient is the sum
    of the four seeds over its rows (a slice alone would miss three)."""
    rng = np.random.default_rng(1)
    n = thread_group.n
    x = _rng_tensor(rng, 2, 8, 3, 2)
    seeds = [_rng_tensor(rng, 2, 8, 3, 2) for _ in range(n)]
    ref = x.clone().requires_grad_(True)
    sum((ref * seeds[s]).sum() for s in range(n)).backward()
    pieces = list(x.split(8 // n, dim=1))
    got = _sharded_grads(thread_group, pieces, collectives.gather_rows,
                         seeds)
    torch.testing.assert_close(torch.cat(got, 1), ref.grad, rtol=0,
                               atol=1e-6)


def test_gather_channels_backward_takes_the_slice(thread_group):
    """Every model rank continues from the same gathered map with the same
    seed: the unsharded function is the map used once, so a slice's
    gradient is the seed's slice, with no reduction."""
    rng = np.random.default_rng(2)
    n = thread_group.n
    x = _rng_tensor(rng, 2, 3, 3, 8)
    seed = _rng_tensor(rng, 2, 3, 3, 8)
    ref = x.clone().requires_grad_(True)
    (ref * seed).sum().backward()
    pieces = list(x.split(8 // n, dim=-1))
    got = _sharded_grads(thread_group, pieces, collectives.gather_channels,
                         [seed] * n)
    torch.testing.assert_close(torch.cat(got, -1), ref.grad, rtol=0, atol=0)


def test_sum_primitives_backward(thread_group):
    """``sum_over``: each rank's seed on the sum reaches every piece;
    ``grad_sum_over``: a map every rank uses with its own seed (a
    tensor-parallel conv's input) gets the sum of the seeds."""
    rng = np.random.default_rng(3)
    n = thread_group.n
    pieces = [_rng_tensor(rng, 5) for _ in range(n)]
    seeds = [_rng_tensor(rng, 5) for _ in range(n)]
    ref = [p.clone().requires_grad_(True) for p in pieces]
    total = sum(ref)
    sum((total * seeds[s]).sum() for s in range(n)).backward()
    got = _sharded_grads(thread_group, pieces, collectives.sum_over, seeds)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r.grad, rtol=0, atol=1e-6)
    x = pieces[0]
    ref = x.clone().requires_grad_(True)
    sum((ref * seeds[s]).sum() for s in range(n)).backward()
    got = _sharded_grads(thread_group, [x] * n, collectives.grad_sum_over,
                         seeds)
    for g in got:
        torch.testing.assert_close(g, ref.grad, rtol=0, atol=1e-6)


def test_port_version_is_the_jax_packages():
    from robotic_discovery_platform_tpu_torch import version

    assert tpkg.__version__ == version.__version__ == "0.1.0"
    assert tpkg.__version__ == jpkg.__version__
    assert "__version__" in tpkg.__all__
