"""Print a fully merged config (counterpart of ``tools/print_config.py``).

    python -m bonai_tpu_torch.tools.print_config CONFIG [--options k=v ...]

``--options`` are merged as the train CLI merges them
(``tools/train.py::parse_options``).
"""

from __future__ import annotations

import argparse

from ..config import Config
from .train import parse_options


def main(argv=None):
    parser = argparse.ArgumentParser(description="Print a merged config")
    parser.add_argument("config")
    parser.add_argument("--options", nargs="+", default=None)
    args = parser.parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_dict(parse_options(args.options))
    print(f"Config path: {cfg.filename}\n")
    print(cfg.pretty_text)


if __name__ == "__main__":
    main()
