"""Train CLI (presight_tpu/scripts/train.py): pick a named method config,
apply dotted overrides, stamp a timestamp, write config.yml, train.

Usage:
  python -m presight_tpu_torch.scripts.train <method> [--a.b.c value ...]
  python -m presight_tpu_torch.scripts.train --list

Runs on the CUDA card; ``main(argv, device=...)`` takes another device.
"""

from __future__ import annotations

import dataclasses
import sys
from datetime import datetime


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from ..configs.config_io import apply_overrides, parse_cli_overrides
    from ..configs.method_configs import method_configs

    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("methods:", ", ".join(sorted(method_configs)))
        return 0
    if argv[0] == "--list":
        for name in sorted(method_configs):
            print(name)
        return 0

    method = argv[0]
    if method not in method_configs:
        print(f"unknown method {method!r}; use --list", file=sys.stderr)
        return 1
    config = method_configs[method]
    overrides = parse_cli_overrides(argv[1:])
    if overrides:
        config = apply_overrides(config, overrides)
    if not config.timestamp:
        config = dataclasses.replace(
            config, timestamp=datetime.now().strftime("%Y-%m-%d_%H%M%S"))

    from ..engine.trainer import Trainer

    trainer = Trainer(config, device=device)
    trainer.setup()
    print(f"run dir: {trainer.run_dir}", flush=True)
    trainer.train()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
