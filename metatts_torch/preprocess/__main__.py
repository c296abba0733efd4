"""Preprocess corpora with the port:

    python -m metatts_torch.preprocess config/preprocess/LibriTTS.yaml [more.yaml ...] [--device cuda|cpu]

Each YAML is overlaid on the preprocess defaults and run through
``Preprocessor(config, device).build_from_path()``: the log-mel and energy
of every utterance on ``device`` (default ``cuda``), the rest on the host.
"""

import argparse

from ..config import load_preprocess_configs
from .preprocessor import Preprocessor


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m metatts_torch.preprocess")
    parser.add_argument("configs", nargs="+", help="preprocess YAML files")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    for cfg in load_preprocess_configs(args.configs):
        outs = Preprocessor(cfg, device=args.device).build_from_path()
        print(f"{cfg['dataset']}: " + ", ".join(
            f"{dset} {len(lines)} utterances" for dset, lines in outs.items()))


if __name__ == "__main__":
    main()
