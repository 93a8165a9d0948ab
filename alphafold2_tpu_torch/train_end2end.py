"""End-to-end structure training on the port: the counterpart of the repo's
``train_end2end.py``.

    python -m alphafold2_tpu_torch.train_end2end                # on the card
    python -m alphafold2_tpu_torch.train_end2end train.num_steps=2 data.crop_len=8 \
        model.dim=16 model.max_seq_len=48 --device=cpu

Arguments are ``section.field=value`` overrides of the base config,
``ModelConfig(dim=256, depth=1)`` and ``DataConfig(crop_len=64)`` with
every other default, plus ``--device=cpu|cuda`` (default: the card;
without one it raises). ``train.checkpoint_dir=DIR`` keeps checkpoints
there and resumes from the latest.
"""

from __future__ import annotations

import sys

from alphafold2_tpu_torch.config import Config, DataConfig, ModelConfig, parse_cli
from alphafold2_tpu_torch.train_pre import split_device


def main(argv) -> None:
    device, rest = split_device(argv)
    cfg = parse_cli(rest, Config(model=ModelConfig(dim=256, depth=1),
                                 data=DataConfig(crop_len=64)))
    print("config:", cfg.to_json(), flush=True)
    from alphafold2_tpu_torch.train.end2end import train_end2end

    train_end2end(cfg, device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
