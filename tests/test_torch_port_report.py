"""The run report (``mercury_tpu_torch/obs/report.py``) against the JAX
package's (``mercury_tpu/obs/report.py``).

- The JAX package's run fixtures (``tests/fixtures/run_report``) give the
  same markdown and HTML, the same ``diff_runs`` lines and the same CLI
  exit codes in both packages; the committed tolerance rules are a copy.
- A port run directory (a CPU fit with ``log_dir``, ``trace``, the
  supervisor, the journal, the NaN injection's flight record and profiler
  window) gives the JAX report's text plus the manifest's ``torch`` and
  ``cuda`` rows; two such runs diff as in the JAX package (equal losses),
  and ``--diff`` of a run with itself exits 0.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mercury_tpu.obs import report as jrep  # noqa: E402
from mercury_tpu_torch import TrainConfig, Trainer  # noqa: E402
from mercury_tpu_torch.data import cifar  # noqa: E402
from mercury_tpu_torch.data.pipeline import make_sharded_dataset  # noqa: E402
from mercury_tpu_torch.obs import report as trep  # noqa: E402
from test_torch_port_ranks import tiny_resnet  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "run_report")
RUN_A, RUN_B = os.path.join(FIXTURES, "run_a"), os.path.join(FIXTURES, "run_b")


def test_tolerances_are_the_jax_rules():
    mine, theirs = trep.load_tolerances(), jrep.load_tolerances()
    assert mine["rules"] == theirs["rules"] and mine["window"] == theirs["window"]
    assert trep.TOLERANCES_SCHEMA == jrep.TOLERANCES_SCHEMA


@pytest.mark.parametrize("run", [RUN_A, RUN_B], ids=["run_a", "run_b"])
def test_fixture_reports_equal_jax(run):
    mine, theirs = trep.load_run(run), jrep.load_run(run)
    assert mine == theirs
    blocks = trep._run_blocks(mine)
    assert blocks == jrep._run_blocks(theirs)
    assert trep.render_markdown(blocks) == jrep.render_markdown(blocks)
    assert trep.render_html(blocks) == jrep.render_html(blocks)


@pytest.mark.parametrize("pair", [(RUN_A, RUN_B), (RUN_B, RUN_A), (RUN_A, RUN_A)],
                         ids=["a-b", "b-a", "a-a"])
def test_diff_equals_jax(pair, capsys, tmp_path):
    rules = trep.load_tolerances()
    mine = trep.diff_runs(trep.load_run(pair[0]), trep.load_run(pair[1]), rules)
    theirs = jrep.diff_runs(jrep.load_run(pair[0]), jrep.load_run(pair[1]), rules)
    assert mine == theirs
    rc_mine = trep.main(["--diff", *pair, "--out", str(tmp_path / "a.md")])
    rc_theirs = jrep.main(["--diff", *pair, "--out", str(tmp_path / "b.md")])
    assert rc_mine == rc_theirs == (1 if mine[0] else 0)
    assert open(tmp_path / "a.md").read() == open(tmp_path / "b.md").read()


def _port_run(log_dir):
    (x, y), (xt, yt) = cifar.synthetic_cifar(10, 48, 8, seed=0)
    ds = make_sharded_dataset((x, y), (xt, yt), [np.arange(48)], cifar.CIFAR10_MEAN,
                              cifar.CIFAR10_STD, 10, device=torch.device("cpu"))
    cfg = TrainConfig(dataset="synthetic", world_size=1, batch_size=4, presample_batches=2,
                      compute_dtype="float32", num_epochs=1, steps_per_epoch=8,
                      eval_every=4, log_every=2, heartbeat_every=0, seed=0,
                      sampler="scoretable", refresh_size=8, trace=True, log_dir=log_dir,
                      supervise=True, anomaly_inject_nan_step=3, anomaly_profile_steps=2)
    tr = Trainer(cfg, dataset=ds, device="cpu", model=tiny_resnet(seed=0))
    try:
        tr.fit()
    finally:
        tr.close()


def test_port_run_reports_as_jax_with_torch_rows(tmp_path, capsys):
    run = str(tmp_path / "run")
    _port_run(run)
    names = set(os.listdir(run))
    assert {"run_manifest.json", "metrics.jsonl", "metrics.h0.jsonl", "events.h0.jsonl",
            "supervisor_summary.json", "trace.json", "device_time_breakdown.json",
            "flight_record_step4_non_finite.json"} <= names, names
    mine = trep.render_markdown(trep._run_blocks(trep.load_run(run)))
    theirs = jrep.render_markdown(jrep._run_blocks(jrep.load_run(run)))
    manifest = json.load(open(os.path.join(run, "run_manifest.json")))
    extra = [f"- **torch**: {manifest['torch_version']}",
             f"- **cuda**: {manifest['cuda_version']}"]
    assert extra[0] in mine
    assert [line for line in mine.splitlines() if line not in extra] == theirs.splitlines()
    for section in ("## Supervisor summary", "## Run timeline", "## Flight records",
                    "## Sampler health", "Span trace:"):
        assert section in mine, section

    other = str(tmp_path / "other")
    _port_run(other)
    rules = trep.load_tolerances()
    mine = trep.diff_runs(trep.load_run(run), trep.load_run(other), rules)
    assert mine == jrep.diff_runs(jrep.load_run(run), jrep.load_run(other), rules)
    assert any(line.startswith("ok train/loss") for line in mine[1])
    assert trep.main(["--diff", run, run]) == 0
    assert trep.main([run, "--html", "--out", str(tmp_path / "r.html")]) == 0
    out = capsys.readouterr().out
    assert "Run diff" in out and "verdict**: OK" in out
    assert open(tmp_path / "r.html").read().startswith("<!doctype html>")


def test_offline_tools_never_import_torch(tmp_path):
    """The report and the attribution run where only the run directory is:
    in a fresh interpreter neither loads torch (the package's names are
    lazy)."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fixture = os.path.join(root, "tests", "fixtures", "profile_trace.json")
    code = ("import sys\n"
            "from mercury_tpu_torch.obs import report, profile_parse\n"
            f"assert report.main([{RUN_A!r}, '--out', {str(tmp_path / 'r.md')!r}]) == 0\n"
            f"assert report.main(['--diff', {RUN_A!r}, {RUN_A!r}]) == 0\n"
            f"assert profile_parse.main([{fixture!r}, '--out', "
            f"{str(tmp_path / 'bd.json')!r}]) == 0\n"
            "assert 'torch' not in sys.modules, 'torch was imported'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
