"""Command line of the port — the counterpart of ``mercury_tpu/cli.py``.

    python -m mercury_tpu_torch [--<field> VALUE ...] [--print-config]
                                [--dry-run] [--distributed] [--device DEV]

Every :class:`~mercury_tpu_torch.config.TrainConfig` field is a flag,
spelled and coerced as the JAX package's command line spells and coerces
it; a flag of a field the port does not have is an error (exit 2), never
ignored. ``--print-config`` prints the resolved config as JSON;
``--dry-run`` builds the trainer, runs one step and prints its metrics as
one JSON line; otherwise ``fit()`` runs and its result is printed.

The run trains on this rank's card; ``--device cpu`` trains on the CPU,
and only when asked. ``--distributed`` joins the process group that
``torchrun --nproc_per_node=W -m mercury_tpu_torch --distributed
--world-size W`` sets up (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` from
its environment): NCCL on the card, gloo with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, Optional, Sequence, Tuple

import torch

from mercury_tpu_torch.config import TrainConfig

AUDIT_NOT_PORTED = ("--audit is not ported: it needs the lint layers of the port "
                    "(ROADMAP.md, Queue 1 item 9)")


def _add_config_flags(parser: argparse.ArgumentParser) -> None:
    """One flag per TrainConfig field (the dataclass is the only source)."""
    for field in dataclasses.fields(TrainConfig):
        name = "--" + field.name.replace("_", "-")
        default = field.default
        ftype = field.type
        if ftype == "bool" or isinstance(default, bool):
            parser.add_argument(
                name, type=lambda s: s.lower() in ("1", "true", "yes"),
                default=default, metavar="BOOL", help=f"(default: {default})")
        elif isinstance(default, int) and not isinstance(default, bool):
            parser.add_argument(name, type=int, default=default,
                                help=f"(default: {default})")
        elif isinstance(default, float):
            parser.add_argument(name, type=float, default=default,
                                help=f"(default: {default})")
        else:  # str / Optional[str] / Optional[int] / Optional[bool]
            parser.add_argument(name, type=str, default=default,
                                help=f"(default: {default})")


def build_parser() -> argparse.ArgumentParser:
    """The parser: the config's flags and the command line's own. Flags are
    matched whole (no abbreviations), so a flag the port lacks is an
    error."""
    parser = argparse.ArgumentParser(
        prog="mercury_tpu_torch", allow_abbrev=False,
        description="Importance-sampled data-parallel training on the GPU")
    _add_config_flags(parser)
    parser.add_argument("--distributed", action="store_true",
                        help="join the torchrun process group (NCCL; gloo with "
                             "--device cpu) before building the trainer")
    parser.add_argument("--dry-run", action="store_true",
                        help="build everything, run one step, print its metrics, exit")
    parser.add_argument("--audit", action="store_true",
                        help="not ported yet: exits non-zero")
    parser.add_argument("--print-config", action="store_true",
                        help="print the resolved config as JSON and exit")
    parser.add_argument("--device", type=str, default=None,
                        help="the device to train on (default: this rank's card; "
                             "'cpu' only when asked)")
    return parser


def parse_config(argv: Optional[Sequence[str]] = None
                 ) -> Tuple[TrainConfig, argparse.Namespace]:
    args = build_parser().parse_args(argv)
    kw = {}
    for f in dataclasses.fields(TrainConfig):
        name, ftype = f.name, str(f.type)
        value = getattr(args, name)
        # Optional[int] fields arrive as strings from argparse.
        if isinstance(value, str) and value.isdigit() and "int" in ftype:
            value = int(value)
        # "none"/"" mean None only for Optional fields: a plain-str enum may
        # use "none" as a value (grad_compression).
        if (isinstance(value, str) and value.lower() in ("none", "")
                and "Optional" in ftype):
            value = None
        # Optional[bool] fields (use_pallas) arrive as strings.
        if (isinstance(value, str) and "bool" in ftype
                and value.lower() in ("true", "false", "yes", "no", "1", "0")):
            value = value.lower() in ("true", "yes", "1")
        kw[name] = value
    return TrainConfig(**kw), args


def _host_metrics(metrics: Dict[str, torch.Tensor]) -> Dict:
    """A step's metrics for JSON: a scalar as a float, a vector (the drawn
    positions and their distribution) as a list."""
    out = {}
    for k, v in metrics.items():
        v = v.detach().cpu()
        out[k] = float(v) if v.numel() == 1 else v.tolist()
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    config, args = parse_config(argv)
    if args.print_config:
        print(json.dumps(dataclasses.asdict(config), indent=2, default=str))
        return 0
    if args.audit:
        print(f"mercury_tpu_torch: {AUDIT_NOT_PORTED}", file=sys.stderr)
        return 2

    from mercury_tpu_torch.parallel import distributed

    joined = False
    if args.distributed:
        cpu = args.device is not None and torch.device(args.device).type == "cpu"
        # world_size × tensor_parallel (or × fsdp_parallel) ranks.
        n = 1 if config.second_axis is None else config.second_axis[1]
        distributed.init_distributed(config.world_size * n, "gloo" if cpu else "nccl")
        joined = True
    try:
        from mercury_tpu_torch.train.trainer import Trainer

        # A context manager: closes the scorer and the prefetch worker, then
        # drains and closes the metric writer.
        with Trainer(config, device=args.device) as trainer:
            print(f"run: {config.run_name()}  mesh: {trainer.mesh.shape}  "
                  f"steps/epoch: {trainer.steps_per_epoch}")
            if args.dry_run:
                # Under host_stream train_step is the fit loop's pop → step
                # → push.
                print(json.dumps(_host_metrics(trainer.train_step())))
                return 0
            final = trainer.fit()
            print(json.dumps(final))
        return 0
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
