"""Train entry point of the port:

    python -m neuradar_tpu_torch.scripts.train <method> [--device cpu] [--path.to.field value]...

A method picks a TrainerConfig preset, dotted overrides change any field
(``--help`` after the method lists them), and the run directory
``<output_dir>/<experiment_name>/<method_name>`` receives ``config.json``, the
event logs, the checkpoints and ``final_metrics.json``. It trains on the card
(``cuda``) unless ``--device`` says otherwise. To resume, pass the run's
``--load_dir <run dir>/checkpoints``: training continues to
``--max_num_iterations``. The splatfacto presets build their own trainer
(``SplatfactoTrainerConfig.setup``), whose run directory receives ``gaussians.npz`` in place of the
checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import List, Tuple


def config_to_jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: config_to_jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: config_to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [config_to_jsonable(v) for v in obj]
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return obj
    return repr(obj)


def pop_device(argv: List[str], default: str = "cuda") -> Tuple[str, List[str]]:
    """Take ``--device X`` (or ``--device=X``) out of argv."""
    rest, device, i = [], default, 0
    while i < len(argv):
        if argv[i] == "--device":
            if i + 1 >= len(argv):
                raise SystemExit("missing value for --device")
            device, i = argv[i + 1], i + 2
        elif argv[i].startswith("--device="):
            device, i = argv[i].split("=", 1)[1], i + 1
        else:
            rest.append(argv[i])
            i += 1
    return device, rest


def main(argv=None) -> int:
    from neuradar_tpu_torch.configs.cli import describe, parse_overrides
    from neuradar_tpu_torch.configs.method_configs import get_method, method_configs, method_descriptions
    from neuradar_tpu_torch.engine.trainer import Trainer

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: train.py <method> [--device cuda|cpu] [--path.to.field value]...")
        print("methods:")
        for name in sorted(method_configs):
            print(f"  {name}: {method_descriptions.get(name, '')}")
        return 0
    method = argv.pop(0)
    device, argv = pop_device(argv)
    config = get_method(method)
    if argv and argv[0] in ("-h", "--help"):
        print(f"overridable fields for {method}:")
        print("\n".join(describe(config)))
        return 0
    parse_overrides(config, argv)

    if method.startswith("splatfacto"):
        trainer = config.setup(device=device)
    else:
        trainer = Trainer(config, device=device)
    run_dir = trainer.run_dir
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "config.json").write_text(json.dumps(config_to_jsonable(config), indent=2))
    print(f"[train] method={method} device={device} -> {run_dir}", flush=True)
    if method.startswith("splatfacto"):
        metrics = trainer.train()
    else:
        trainer.setup()
        try:
            metrics = trainer.train()
        finally:
            trainer.shutdown()
    (run_dir / "final_metrics.json").write_text(json.dumps(metrics, indent=2))
    print(json.dumps({k: round(v, 5) for k, v in metrics.items() if isinstance(v, float)}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
