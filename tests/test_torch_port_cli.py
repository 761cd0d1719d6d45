"""The port's command line (``python -m mercury_tpu_torch``) against the
JAX package's ``mercury_tpu.cli``: the same flags for the port's fields,
the same parsed config and ``--print-config``; a JAX-only flag refused;
``--dry-run`` on the CPU in-process, as two torchrun-style ranks over gloo,
and refused without a card unless ``--device cpu`` is given.

Small: full-width ResNet-18 at batch 4 with a pool of 8 in float32; each
subprocess has a 120 s limit.
"""

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mercury_tpu import cli as jcli  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch import cli  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FIELDS = [f.name for f in dataclasses.fields(TrainConfig)]
SMALL = ["--dataset", "synthetic", "--batch-size", "4", "--presample-batches", "2",
         "--compute-dtype", "float32"]
TIMEOUT_S = 120


def _options(parser):
    return {a.dest: tuple(a.option_strings) for a in parser._actions if a.option_strings}


def test_every_field_has_the_jax_flag():
    jparser = argparse.ArgumentParser()
    jcli._add_config_flags(jparser)
    want, got = _options(jparser), _options(cli.build_parser())
    for name in PORT_FIELDS:
        assert got[name] == want[name] == ("--" + name.replace("_", "-"),), name
    assert set(got) - set(PORT_FIELDS) == {"help", "distributed", "dry_run", "audit",
                                           "print_config", "device"}


@pytest.mark.parametrize("argv", [
    [],
    ["--use-pallas", "false"],
    ["--grad-compression", "none"],
    ["--checkpoint-dir", "none", "--log-dir", "", "--num-classes", "10"],
    ["--model", "resnet50", "--seed", "7", "--steps-per-epoch", "12", "--base-lr", "0.01"],
    ["--cutout", "yes", "--noniid", "0", "--use-pallas", "yes", "--heartbeat-every", "5"],
], ids=["defaults", "use_pallas-false", "grad_compression-none", "none-to-None",
        "model-seed", "bool-spellings"])
def test_parse_config_matches_jax(argv):
    jconfig, _ = jcli.parse_config(argv)
    config, _ = cli.parse_config(argv)
    for name in PORT_FIELDS:
        assert getattr(config, name) == getattr(jconfig, name), name
    assert config.run_name() == jconfig.run_name()
    if argv[:2] == ["--grad-compression", "none"]:
        assert config.grad_compression == "none"


def test_print_config_matches_jax(capsys):
    assert jcli.main(["--print-config", "--seed", "3"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main(["--print-config", "--seed", "3"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert list(got) == PORT_FIELDS
    assert got == {k: want[k] for k in PORT_FIELDS}


@pytest.mark.parametrize("flag", [["--plan", "auto"], ["--plan-memory-budget-bytes", "0"],
                                  ["--log-ev", "5"]])
def test_flags_the_port_lacks_are_refused(flag, capsys):
    with pytest.raises(SystemExit) as exit_:
        cli.main(flag + ["--print-config"])
    assert exit_.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_audit_exits_nonzero_naming_its_item(capsys):
    assert cli.main(["--audit", "--device", "cpu"]) != 0
    assert "Queue 1 item 9" in capsys.readouterr().err


def test_dry_run_prints_the_step_metrics(capsys, monkeypatch):
    seen = {}
    step = Trainer.train_step

    def spy(self, *a, **kw):
        seen["metrics"] = step(self, *a, **kw)
        return seen["metrics"]

    monkeypatch.setattr(Trainer, "train_step", spy)
    assert cli.main(SMALL + ["--world-size", "1", "--device", "cpu", "--dry-run"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("run: resnet18_synthetic_is_noniid_w1_b4_")
    assert "mesh: {'data': 1}" in lines[0]
    metrics = json.loads(lines[-1])
    assert set(metrics) == set(seen["metrics"])
    assert np.isfinite(metrics["train/loss"]) and len(metrics["sampler/probs"]) == 8


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
def test_no_card_and_no_device_fails():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(SMALL + ["--world-size", "1", "--dry-run"])


def _run(args, env=None):
    return subprocess.Popen([sys.executable, "-m", "mercury_tpu_torch", *args], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_module_entry_point_prints_the_config():
    proc = _run(["--print-config", "--world-size", "2"])
    out, err = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == 0, err
    assert json.loads(out)["world_size"] == 2


def test_distributed_dry_run_as_two_ranks():
    """torchrun's environment for two ranks on this host; gloo on the CPU.
    The step's scalars are averaged over the ranks, so both print the same;
    the drawn positions and their distribution are each rank's own."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(_run(SMALL + ["--world-size", "2", "--device", "cpu", "--distributed",
                                   "--dry-run"], env))
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=TIMEOUT_S)
            assert proc.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    scalars = [{k: v for k, v in o.items() if not isinstance(v, list)} for o in outs]
    assert scalars[0] == scalars[1] and np.isfinite(scalars[0]["train/loss"])
    assert set(outs[0]) == set(outs[1]) and len(scalars[0]) > 20
