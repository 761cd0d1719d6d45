"""The status server (``mercury_tpu_torch/obs/serve.py``) against the JAX
package's (``mercury_tpu/obs/serve.py``), and ``serve_port`` on the
port's Trainer.

- ``render_openmetrics`` gives the same text, ``parse_openmetrics`` the
  same samples and the same refusals, ``metric_name`` the same names.
- A loopback ``StatusServer`` of each package, on the same callbacks,
  answers every path with the same status, content type and body: 200 and
  503 from ``/healthz`` (healthy, degraded, a raising callback), the
  documents of ``/statusz`` and ``/metricsz``, 404 elsewhere.
- An out-of-range ``serve_port`` raises the JAX Trainer's ``ValueError``.
- A CPU fit with ``serve_port`` answers on rank 0 during the fit:
  ``/metricsz`` parses back to the writer's latest record, ``/statusz``
  holds the manifest, the supervisor and the journal's tail with
  ``state_schema_sha`` None, and after ``close`` nothing listens.
"""

import http.client
import json
import math
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mercury_tpu.config import TrainConfig as JConfig  # noqa: E402
from mercury_tpu.obs import serve as jserve  # noqa: E402
from mercury_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.obs import serve as tserve  # noqa: E402
from test_torch_port_ranks import tiny_resnet  # noqa: E402

RECORD = {"step": 40.0, "train/loss": 2.25, "perf/steps_per_s": 61.5, "time": 1.7e9,
          "sampler_dist/w_hist/b03": 7, "host/straggler_ratio": float("inf"),
          "weird key-with.chars": -0.0, "train/nan": float("nan"), "note": "text",
          "flag": True, "none": None}


@pytest.mark.parametrize("record", [RECORD, {}, None], ids=["record", "empty", "none"])
@pytest.mark.parametrize("prefix", ["mercury", ""])
def test_render_and_parse_equal_jax(record, prefix):
    text = tserve.render_openmetrics(record, prefix=prefix)
    assert text == jserve.render_openmetrics(record, prefix=prefix)
    mine, theirs = tserve.parse_openmetrics(text), jserve.parse_openmetrics(text)
    assert json.dumps(mine, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    for key in (record or {}):
        assert tserve.metric_name(key, prefix) == jserve.metric_name(key, prefix)


@pytest.mark.parametrize("text", [
    "x 1\n", "# EOF\nx 1\n", "# BOGUS a b\n# EOF\n", "bad-name 1\n# EOF\n",
    "x notanumber\n# EOF\n",
], ids=["no-eof", "after-eof", "bad-meta", "bad-name", "bad-value"])
def test_parse_refuses_what_jax_refuses(text):
    errors = []
    for mod in (tserve, jserve):
        with pytest.raises(ValueError) as err:
            mod.parse_openmetrics(text)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def _get(port, path):
    """GET on the loopback (``http.client``: no proxy is consulted)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read().decode()
    finally:
        conn.close()


def _raising():
    raise RuntimeError("supervisor gone")


@pytest.mark.parametrize("health", [
    lambda: {"level": 0, "step": 3}, lambda: {"level": 2, "level_name": "frozen"},
    lambda: {"healthy": False}, _raising, None,
], ids=["healthy", "degraded", "unhealthy", "raising", "none"])
def test_loopback_servers_answer_as_jax(health):
    status = lambda: {"step": 3, "events": [{"kind": "fault/fired"}]}  # noqa: E731
    servers = [mod.StatusServer(0, health_fn=health, status_fn=status,
                                metrics_fn=lambda: dict(RECORD))
               for mod in (tserve, jserve)]
    try:
        assert servers[0]._thread.name == "mercury-serve"
        for path in ("/healthz", "/statusz", "/metricsz", "/metricsz/?x=1", "/nope"):
            mine, theirs = (_get(s.port, path) for s in servers)
            assert mine == theirs, path
        assert _get(servers[0].port, "/nope")[0] == 404
    finally:
        for s in servers:
            s.close()
            s.close()


@pytest.mark.parametrize("port", [-1, 65536])
def test_out_of_range_serve_port_raises_the_jax_error(port):
    with pytest.raises(ValueError) as theirs:
        JTrainer(JConfig(serve_port=port))
    with pytest.raises(ValueError) as mine:
        Trainer(TrainConfig(world_size=1, serve_port=port), device="cpu")
    assert str(mine.value) == str(theirs.value)
    assert TrainConfig(world_size=1).serve_port == JConfig().serve_port == 0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_fit_serves_on_rank_0(tmp_path):
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, 48, 8, seed=0)
    ds = make_sharded_dataset((x, y), (xt, yt), [np.arange(48)], cifar.CIFAR10_MEAN,
                              cifar.CIFAR10_STD, 10, device=torch.device("cpu"))
    port = _free_port()
    cfg = TrainConfig(dataset="synthetic", world_size=1, batch_size=4, presample_batches=2,
                      compute_dtype="float32", num_epochs=1, steps_per_epoch=6,
                      eval_every=0, log_every=2, heartbeat_every=0, seed=0,
                      serve_port=port, log_dir=str(tmp_path), supervise=True)
    tr = Trainer(cfg, dataset=ds, device="cpu", model=tiny_resnet(seed=0))
    try:
        code, _, body = _get(port, "/healthz")
        assert code == 200 and json.loads(body) == {
            "alive": True, "step": 0, "level": 0, "level_name": "async", "units_down": 0,
            "healthy": True}
        tr.fit()
        tr.logger.flush()
        samples = tserve.parse_openmetrics(_get(port, "/metricsz")[2])
        latest = tr.logger.latest_record()
        want = {tserve.metric_name(k): float(v) for k, v in latest.items()
                if isinstance(v, (int, float))}
        assert samples.keys() == want.keys() and "mercury_train_loss" in samples
        assert all(samples[k] == want[k] or (math.isnan(samples[k]) and math.isnan(want[k]))
                   for k in want)
        doc = json.loads(_get(port, "/statusz")[2])
        assert doc["endpoint"] == "/statusz" and doc["step"] == 6
        assert doc["manifest"]["schema"] == "mercury_run_manifest_v1"
        assert doc["supervisor"]["level_name"] == "async"
        assert doc["state_schema_sha"] is None and "event_counts" in doc
    finally:
        tr.close()
        tr.close()
    with pytest.raises(ConnectionRefusedError):   # closed: nothing listens
        _get(port, "/healthz")
