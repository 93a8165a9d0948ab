"""Distogram pretraining on the port: the counterpart of the repo's
``train_pre.py``.

    python -m alphafold2_tpu_torch.train_pre                    # on the card
    python -m alphafold2_tpu_torch.train_pre train.num_steps=3 data.crop_len=16 \
        model.dim=32 --device=cpu

Arguments are ``section.field=value`` overrides of the base config,
``ModelConfig(dim=256, depth=1)`` with every other default, plus
``--device=cpu|cuda`` (default: the card; without one it raises).
"""

from __future__ import annotations

import sys

from alphafold2_tpu_torch.config import Config, ModelConfig, parse_cli


def split_device(argv) -> tuple:
    """``(device, the other arguments)``: ``--device=cpu|cuda`` or None."""
    device = None
    rest = []
    for arg in argv:
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    return device, rest


def main(argv) -> None:
    device, rest = split_device(argv)
    cfg = parse_cli(rest, Config(model=ModelConfig(dim=256, depth=1)))
    print("config:", cfg.to_json(), flush=True)
    from alphafold2_tpu_torch.train.loop import train

    train(cfg, device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
