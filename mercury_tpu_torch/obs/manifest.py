"""Run manifest: the one JSON file that makes a metrics stream readable
later — the PyTorch counterpart of ``mercury_tpu/obs/manifest.py``.

Written once at trainer start, next to ``metrics.jsonl``: the resolved
config, the software versions (torch and CUDA), the ranks and the card
the numbers came from, the card's peak, and the git revision of the
code. Same schema string and keys as the JAX package's, with
``torch_version`` and ``cuda_version`` in place of ``jax_version`` and
``jaxlib_version``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
from typing import Dict, Optional

import torch

from mercury_tpu_torch.obs.accounting import peak_flops
from mercury_tpu_torch.parallel.collectives import rank, world

SCHEMA = "mercury_run_manifest_v1"


def git_revision(cwd: Optional[str] = None) -> Optional[str]:
    """The current git sha of the checkout holding this package (with a
    ``-dirty`` suffix when the tree has local changes), or None without git
    or a repository."""
    try:
        root = cwd or os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        sha = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root,
                             capture_output=True, text=True, timeout=5)
        if sha.returncode != 0:
            return None
        rev = sha.stdout.strip()
        dirty = subprocess.run(["git", "status", "--porcelain"], cwd=root,
                               capture_output=True, text=True, timeout=5)
        if dirty.returncode == 0 and dirty.stdout.strip():
            rev += "-dirty"
        return rev
    except Exception:
        return None


def build_run_manifest(config, device=None, extra: Optional[Dict] = None) -> Dict:
    """The manifest dict (no filesystem). ``device`` is the trainer's
    (default: this rank's card when CUDA is available, else the CPU);
    ``process_index`` and ``process_count`` are the global rank and the
    ranks, and ``mesh_shape`` maps each mesh axis to its size, as the JAX
    manifest's ``dict(mesh.shape)``: ``{mesh_axis: world_size}``, with the
    second axis (``model_axis: tensor_parallel`` or ``fsdp_axis:
    fsdp_parallel``) when one is above 1; ``mesh_axis_names`` their
    names in order."""
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    device = torch.device(device)
    manifest: Dict = {
        "schema": SCHEMA,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "run_name": config.run_name(),
        "config": dataclasses.asdict(config),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "git_sha": git_revision(),
        "process_index": rank(),
        "process_count": world(),
    }
    if device.type == "cuda":
        manifest["device_kind"] = torch.cuda.get_device_name(device)
        manifest["platform"] = "gpu"
        manifest["device_count"] = torch.cuda.device_count()
    else:
        manifest["device_kind"] = None
        manifest["platform"] = "cpu"
        manifest["device_count"] = 1
    shape = {config.mesh_axis: int(config.world_size)}
    if config.second_axis is not None:
        name, n = config.second_axis
        shape[name] = int(n)
    manifest["mesh_shape"] = shape
    manifest["mesh_axis_names"] = list(shape)
    manifest["peak_flops"] = peak_flops(manifest["device_kind"])
    if extra:
        manifest.update(extra)
    return manifest


def write_run_manifest(log_dir: str, config, device=None,
                       extra: Optional[Dict] = None) -> str:
    """Write ``run_manifest.json`` into ``log_dir`` on rank 0 (every rank
    computes the same content; one writes). Returns the path."""
    manifest = build_run_manifest(config, device, extra)
    path = os.path.join(log_dir, "run_manifest.json")
    if rank() == 0:
        os.makedirs(log_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(manifest, f, indent=2, default=str)
            f.write("\n")
    return path
