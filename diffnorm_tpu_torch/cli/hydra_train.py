"""fairseq-hydra-train's entry point (the port of
diffnorm_tpu/cli/hydra_train.py; reference fairseq_cli/hydra_train.py):
hydra's dotted `group.key=value` overrides become cli.train's `--key value`
(the group dropped, a list's brackets stripped: `optimization.lr=[5e-4]`
is `--lr 5e-4`), `task.data=PATH` (any group's `data`) becomes the DATA
positional, and the rest passes through unchanged; hydra's config tree
comes in as `--config cfg.yaml` (cli.train's YAML defaults, hydra's groups
flattened). Then cli.train runs.

  python -m diffnorm_tpu_torch.cli.hydra_train task.data=DATA --task dummy_vae \\
      optimization.max_update=2 optimization.lr=[5e-4] --config cfg.yaml --cpu
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

from diffnorm_tpu_torch.cli import train


def rewrite(argv: Sequence[str]) -> List[str]:
    """hydra's overrides as cli.train's arguments (module docstring)."""
    out: List[str] = []
    for a in argv:
        if "=" not in a or a.startswith("-"):
            out.append(a)
            continue
        key, value = a.split("=", 1)
        name = key.split(".")[-1].replace("-", "_")
        value = value.strip("[]")
        if name == "data":
            out.insert(0, value)
        else:
            out += [f"--{name.replace('_', '-')}", value]
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    return train.main(rewrite(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    sys.exit(main())
