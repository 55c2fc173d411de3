"""The port's MLflow REST store (tracking/rest_backend.py) and the tracking
URI routing of tracking/api.py, against tests/fake_mlflow_server.py over a
real socket, beside the JAX package's REST store on the same server.

The cases of tests/test_mlflow_rest.py and the REST cases of
tests/test_resilience.py, run on the port; then both directions between
the packages through one server (a model registered over REST by either
package loads in the other, batch norm and group norm), a port servicer
started from an ``http://`` URI answering as the JAX servicer on the same
version before and after an alias move, and training, registering and a
retraining cycle that promotes over REST.

Tolerances, fixed before measuring: weights and artifacts over the socket
bit for bit; forwards of the same weights in float32 within 1e-4
max-abs; servicer answers as tests/test_torch_port_deploy.py holds them
(statuses, coverage and packed mask payloads identical, curvature rtol
1e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from fake_mlflow_server import FakeMlflowServer

from robotic_discovery_platform_tpu import tracking as jtracking
from robotic_discovery_platform_tpu.models.unet import build_unet, init_unet
from robotic_discovery_platform_tpu.ops import pipeline as jpipe
from robotic_discovery_platform_tpu.serving import server as jserver
from robotic_discovery_platform_tpu.tracking import api as japi
from robotic_discovery_platform_tpu.utils import config as jconfig
from robotic_discovery_platform_tpu_torch import tracking
from robotic_discovery_platform_tpu_torch.io.frames import render_scene
from robotic_discovery_platform_tpu_torch.models import unet as tunet
from robotic_discovery_platform_tpu_torch.models import weights
from robotic_discovery_platform_tpu_torch.resilience import (
    RetryPolicy,
    configure_faults,
    fired,
)
from robotic_discovery_platform_tpu_torch.serving import ingest
from robotic_discovery_platform_tpu_torch.serving import server as tserver
from robotic_discovery_platform_tpu_torch.tracking import api
from robotic_discovery_platform_tpu_torch.tracking.rest_backend import (
    FAULT_SITE,
    MlflowRestError,
    RestMlflowStore,
)
from robotic_discovery_platform_tpu_torch.training import synthetic
from robotic_discovery_platform_tpu_torch.utils import config

NAME = "Actuator-Segmenter"
H, W, SIZE = 120, 160, 64


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


@pytest.fixture(autouse=True)
def _restore_tracking():
    """Both packages' process-global tracking state back as it was."""
    prev = (tracking.get_tracking_uri(), api._state.experiment_id,
            jtracking.get_tracking_uri(), japi._state.experiment_id)
    yield
    tracking.set_tracking_uri(prev[0])
    api._state.experiment_id = prev[1]
    jtracking.set_tracking_uri(prev[2])
    japi._state.experiment_id = prev[3]
    configure_faults(None)


@pytest.fixture()
def server_uri():
    with FakeMlflowServer() as uri:
        yield uri


class FakeClock:
    """Injectable clock and sleep: time moves only when told to."""

    def __init__(self):
        self.now = 0.0
        self.sleeps: list[float] = []

    def __call__(self) -> float:
        return self.now

    def sleep(self, s: float) -> None:
        self.sleeps.append(s)
        self.now += s


def _port_net(norm: str = "batch", seed: int = 0) -> tunet.UNet:
    cfg = config.ModelConfig(base_features=8, compute_dtype="float32",
                             norm=norm)
    net = tunet.UNet(cfg).init_weights(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():  # statistics and affine terms away from init
        for key, t in net.state_dict().items():
            if key.endswith((".scale", ".var")):
                t.uniform_(0.5, 1.5, generator=gen)
            elif key.endswith((".mean", "Norm_0.bias", "Norm_1.bias")):
                t.normal_(0.0, 0.1, generator=gen)
    return net.eval()


# -- the cases of tests/test_mlflow_rest.py ---------------------------------------


def test_http_uri_routes_to_rest_store(server_uri):
    """A bare ``http://`` URI and the forced ``mlflow-rest+`` one both
    select the REST store; ``file:`` the file store."""
    for uri in (server_uri, f"mlflow-rest+{server_uri}"):
        assert isinstance(tracking.store_for(uri), RestMlflowStore)
        tracking.set_tracking_uri(uri)
        assert isinstance(api._store(), RestMlflowStore)
    assert isinstance(tracking.store_for("file:/tmp/x-unused"),
                      tracking.FileStore)


def test_rest_round_trip(server_uri):
    tracking.set_tracking_uri(server_uri)
    tracking.set_experiment("Actuator Segmentation")
    net = _port_net()
    cfg = net.cfg
    with tracking.start_run() as run:
        tracking.log_params({"learning_rate": 1e-4, "batch_size": 4})
        tracking.log_metric("train_loss", 0.7, step=0)
        tracking.log_metric("train_loss", 0.5, step=1)
        version = tracking.log_model(weights.to_flax_variables(net), cfg,
                                     registered_model_name=NAME)
    assert version == 1

    hist = tracking.get_metric_history(run.info.run_id, "train_loss")
    assert [h["step"] for h in hist] == [0, 1]
    assert [h["value"] for h in hist] == [0.7, 0.5]
    assert api._store().get_params(run.info.run_id) == {
        "learning_rate": "0.0001", "batch_size": "4"}
    assert api._store().get_run(run.info.run_id)["status"] == "FINISHED"

    client = tracking.Client()
    client.set_registered_model_alias(NAME, "staging", version)
    assert client.get_model_version_by_alias(NAME, "staging").version == 1
    assert [v.version for v in client.get_latest_versions(NAME)] == [1]
    assert client.list_versions(NAME)[0]["stage"] == "None"

    # the artifacts cross the socket both ways: the same function
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (1, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        want = net(x)
        for uri in (f"models:/{NAME}/latest", f"models:/{NAME}@staging",
                    f"models:/{NAME}/1"):
            loaded_cfg, loaded = tracking.load_model(uri, device="cpu")
            assert loaded_cfg == cfg
            assert torch.equal(loaded(x), want)


def test_rest_error_codes_branch_correctly(server_uri):
    store = tracking.store_for(server_uri)
    # a missing alias or model is None (the serving resolve relies on it)
    assert store.get_alias("No-Such-Model", "staging") is None
    # a second experiment create is an idempotent get
    a = store.get_or_create_experiment("exp-a")
    assert store.get_or_create_experiment("exp-a") == a
    # a version of an unknown model surfaces the server's error
    with pytest.raises(MlflowRestError) as exc_info:
        store._call("POST", "model-versions/create",
                    body={"name": "No-Such-Model", "source": "x"})
    assert exc_info.value.error_code == "RESOURCE_DOES_NOT_EXIST"
    assert exc_info.value.status == 404
    with pytest.raises(KeyError):
        store.latest_version("No-Such-Model")
    # an unknown endpoint: not retried (4xx), the server's code
    with pytest.raises(MlflowRestError, match="ENDPOINT_NOT_FOUND"):
        store._call("GET", "no/such/endpoint")


def test_forced_rest_scheme(server_uri):
    store = api.store_for(f"mlflow-rest+{server_uri}")
    assert isinstance(store, RestMlflowStore)
    exp = store.get_or_create_experiment("forced")
    run_id = store.create_run(exp, run_name="r1")
    store.log_metric(run_id, "m", 1.25, step=3)
    assert store.get_metric_history(run_id, "m") == [
        {"step": 3, "value": 1.25,
         "ts": store.get_metric_history(run_id, "m")[0]["ts"]}
    ]
    store.end_run(run_id)
    got = store.get_run(run_id)
    assert got["status"] == "FINISHED" and got["run_name"] == "r1"
    scratch = store._scratch
    store.close()
    assert not scratch.exists()
    assert store.artifact_dir(run_id).is_dir()  # made again on use
    store.close()


# -- the REST cases of tests/test_resilience.py -----------------------------------


def _rest_store(uri: str, clk: FakeClock, attempts: int = 3):
    return RestMlflowStore(uri, retry=RetryPolicy(
        max_attempts=attempts, base_delay_s=0.1, jitter=0.0, clock=clk,
        sleep=clk.sleep))


@pytest.mark.parametrize("fault", ["conn:2", "http500:1", "conn:-1"])
def test_rest_store_retries_transient_faults(fault, server_uri):
    """Injected connection failures and a 500 retry inside one logical
    call, the backoff on the fake clock; a sustained outage surfaces as
    ``ConnectionError`` after every attempt. Both packages' stores fire
    the same faults and sleep the same schedule."""
    from robotic_discovery_platform_tpu.resilience import (
        RetryPolicy as JRetryPolicy,
    )
    from robotic_discovery_platform_tpu.resilience import (
        configure_faults as jconfigure,
    )
    from robotic_discovery_platform_tpu.resilience import fired as jfired
    from robotic_discovery_platform_tpu.tracking.rest_backend import (
        RestMlflowStore as JRestMlflowStore,
    )

    def run(make_store, configure, fired_at):
        clk = FakeClock()
        store = make_store(clk)
        configure(f"{FAULT_SITE}:{fault}")
        try:
            outcome = store.get_or_create_experiment(f"chaos-{fault}")
        except ConnectionError:
            outcome = "ConnectionError"
        n_fired = fired_at(FAULT_SITE)
        configure(None)
        store.close()
        return outcome, n_fired, clk.sleeps

    got = run(lambda clk: _rest_store(server_uri, clk), configure_faults,
              fired)
    want = run(lambda clk: JRestMlflowStore(server_uri, retry=JRetryPolicy(
        max_attempts=3, base_delay_s=0.1, jitter=0.0, clock=clk,
        sleep=clk.sleep)), jconfigure, jfired)
    assert got[1:] == want[1:]
    assert (got[0] == "ConnectionError") == (want[0] == "ConnectionError")
    if fault == "conn:-1":
        assert got[0] == "ConnectionError" and got[1] == 3
    else:
        assert got[0] and got[1] == int(fault.split(":")[1])
        assert got[2] == pytest.approx([0.1, 0.2][:got[1]])


# -- both directions between the packages -------------------------------------------


@pytest.mark.parametrize("norm", ["batch", "group"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_model_registered_over_rest_loads_in_the_other_package(
        writer, norm, server_uri):
    """One package registers over REST; the other loads the version from
    the same server: the same variables bit for bit, and the same
    function (float32, 1e-4)."""
    x = np.random.default_rng(1).uniform(0, 1, (1, 32, 32, 3)).astype(
        np.float32)
    jcfg = jconfig.ModelConfig(base_features=8, compute_dtype="float32",
                               norm=norm)
    if writer == "port":
        net = _port_net(norm)
        variables = weights.to_flax_variables(net)
        tracking.set_tracking_uri(server_uri)
        tracking.set_experiment("Actuator Segmentation")
        with tracking.start_run():
            version = tracking.log_model(variables, net.cfg,
                                         registered_model_name=NAME)
        jtracking.set_tracking_uri(f"mlflow-rest+{server_uri}")
        model, loaded = jtracking.load_model(f"models:/{NAME}/{version}")
        assert model.norm == norm
        loaded = jax.tree.map(np.asarray, loaded)
        assert sorted(loaded) == sorted(variables)
        for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(variables)):
            np.testing.assert_array_equal(a, b)
        with torch.no_grad():
            want = net(torch.from_numpy(x)).numpy()
        got = np.asarray(model.apply(loaded, jnp.asarray(x), train=False))
    else:
        model = build_unet(jcfg)
        variables = jax.tree.map(np.asarray, jax.jit(
            lambda k: init_unet(model, k, 32))(jax.random.key(3)))
        jtracking.set_tracking_uri(f"mlflow-rest+{server_uri}")
        jtracking.set_experiment("Actuator Segmentation")
        with jtracking.start_run():
            version = jtracking.log_model(variables, jcfg,
                                          registered_model_name=NAME)
        tracking.set_tracking_uri(server_uri)
        cfg, net = tracking.load_model(f"models:/{NAME}/{version}",
                                       device="cpu")
        assert cfg.norm == norm
        back = weights.to_flax_variables(net)
        assert sorted(back) == sorted(variables)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
            np.testing.assert_array_equal(a, b)
        want = np.asarray(model.apply(variables, jnp.asarray(x),
                                      train=False))
        with torch.no_grad():
            got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _jax_variables(seed: int) -> dict:
    """The deploy test's recipe: BatchNorm statistics from a numpy seed
    and the head bias at a frame's median logit, so masks have edges."""
    jcfg = jconfig.ModelConfig(base_features=8, compute_dtype="float32")
    model = build_unet(jcfg)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda key: init_unet(model, key, SIZE))(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.05, 0.2, a.shape) if p[-1].key == "var"
                      else rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    rgb, _, _ = render_scene(np.random.default_rng(100), H, W)
    x = jpipe.preprocess(jnp.asarray(rgb)[None], SIZE)
    median = float(np.median(np.asarray(model.apply(variables, x))))
    variables["params"]["Conv_0"]["bias"] = (
        variables["params"]["Conv_0"]["bias"] - median).astype(np.float32)
    return variables


def _jax_register(rest_uri: str, variables: dict) -> int:
    jcfg = jconfig.ModelConfig(base_features=8, compute_dtype="float32")
    prev = jtracking.get_tracking_uri()
    jtracking.set_tracking_uri(rest_uri)
    try:
        jtracking.set_experiment("Actuator Segmentation")
        with jtracking.start_run():
            version = jtracking.log_model(variables, jcfg,
                                          registered_model_name=NAME)
        jtracking.Client().set_registered_model_alias(NAME, "staging",
                                                      version)
    finally:
        jtracking.set_tracking_uri(prev)
    return version


def _frames(n: int = 4):
    rng = np.random.default_rng(100)
    return [render_scene(rng, H, W)[::2] for _ in range(n)]  # (rgb, depth)


def _port_answers(service, frames):
    return [(r.status, r.mask, r.mask_coverage, r.mean_curvature,
             r.max_curvature)
            for r in service.analyze_stream(iter(
                [ingest.raw_request(rgb, depth, mask_format=1)
                 for rgb, depth in frames]))]


def _jax_answers(jservice, frames):
    out = []
    for rgb, depth in frames:
        res = jservice._analyze_frame(rgb, depth, mask_format=1)
        out.append(("OK" if res.valid else tserver.STATUS_DEGRADED,
                    res.mask_png, float(np.float32(res.coverage)),
                    res.mean_k, res.max_k))
    return out


def _same(got, want):
    for g, w in zip(got, want, strict=True):
        assert g[0] == w[0]
        assert g[1] == w[1]  # packed mask bits, byte for byte
        assert g[2] == w[2]
        if g[0] == "OK":
            np.testing.assert_allclose(g[3:], w[3:], rtol=1e-3, atol=0.0)


@pytest.mark.parametrize("batched", [False, True], ids=["direct", "batched"])
def test_port_server_from_http_answers_as_the_jax_servicer(
        batched, server_uri, tmp_path):
    """A port servicer built from ``http://`` and the JAX servicer from
    the same server answer alike; the ``staging`` alias moves over REST;
    both reloads swap to the new version and answer it alike."""
    rest = f"mlflow-rest+{server_uri}"
    v1 = _jax_register(rest, _jax_variables(0))
    fields = dict(batch_window_ms=5.0, max_batch=2) if batched else {}
    common = dict(address="localhost:0", model_img_size=SIZE,
                  calibration_path=str(tmp_path / "none.npz"),
                  reload_poll_s=0.0, **fields)
    pcfg = config.ServerConfig(tracking_uri=server_uri,
                               metrics_csv=str(tmp_path / "p.csv"), **common)
    jcfg = jconfig.ServerConfig(tracking_uri=rest,
                                metrics_csv=str(tmp_path / "j.csv"),
                                **common)
    frames = _frames()
    service = tserver.build_service(pcfg, device="cpu")
    prev = jtracking.get_tracking_uri()
    try:
        model, variables, version = jserver.resolve_serving_model(jcfg)
    finally:
        jtracking.set_tracking_uri(prev)
    jservice = jserver.VisionAnalysisService(model, variables, None, 0.001,
                                             jcfg, version=version)
    try:
        service.warmup(W, H)
        jservice.warmup(W, H)
        assert service.current_version == jservice.current_version == v1
        before = _port_answers(service, frames)
        _same(before, _jax_answers(jservice, frames))
        v2 = _jax_register(rest, _jax_variables(1))
        assert service.maybe_reload() and jservice.maybe_reload()
        assert service.current_version == jservice.current_version == v2
        after = _port_answers(service, frames)
        _same(after, _jax_answers(jservice, frames))
        assert [a[1] for a in after] != [b[1] for b in before]
    finally:
        service.close()
        jservice.close()


def test_train_register_and_retrain_over_http(server_uri, tmp_path):
    """``train_model`` with an ``http://`` tracking URI logs its run and
    registers version 1 over REST; a retraining cycle registers version 2,
    promotes ``staging`` to it over REST and captures its profile; the JAX
    package loads the promoted version's variables bit for bit."""
    from robotic_discovery_platform_tpu_torch.training import trainer
    from robotic_discovery_platform_tpu_torch.workflows import retraining

    model_cfg = config.ModelConfig(base_features=4, compute_dtype="float32")
    cfg = config.TrainConfig(
        epochs=1, batch_size=4, img_size=32, learning_rate=1e-3,
        validation_split=0.25, tracking_uri=server_uri,
        checkpoint_dir=str(tmp_path / "ckpt"))
    arrays = synthetic.generate_arrays(8, 32, 32, seed=0)
    result = trainer.train_model(cfg, model_cfg, arrays=arrays,
                                 device="cpu")
    assert result.registry_version == 1
    store = tracking.store_for(server_uri)
    assert store.get_run(result.run_id)["status"] == "FINISHED"
    assert [h["step"] for h in store.get_metric_history(
        result.run_id, "val_loss")] == [0]
    assert store.get_params(result.run_id)["base_features"] == "4"

    res = retraining.run_retraining_pipeline(
        dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / "ckpt2")),
        model_cfg, arrays=arrays, device="cpu")
    assert (res.succeeded, res.version, res.promoted_alias) == (
        True, 2, "staging"), res.message
    assert store.get_alias(NAME, "staging") == 2
    assert res.drift_profile_path is not None

    jtracking.set_tracking_uri(f"mlflow-rest+{server_uri}")
    _, jvars = jtracking.load_model(f"models:/{NAME}@staging")
    _, net = tracking.load_model(f"models:/{NAME}@staging", store=store,
                                 device="cpu")
    mine = weights.to_flax_variables(net)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jvars)),
                    jax.tree.leaves(mine)):
        np.testing.assert_array_equal(a, b)
