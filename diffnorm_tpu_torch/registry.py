"""Registration by name and --user-dir plugins (the port of
diffnorm_tpu/registry.py:117-150; reference fairseq/utils.py:464-507).

A plugin is a package or module that registers its tasks, criterions and
architectures with the decorators below when it is imported; the CLIs
that take `--user-dir PATH` import it before they build their parsers, so
its names are valid --task, --criterion and --arch values:

* `register_task(name)`: a Task subclass into `tasks.TASKS`. cli.train
  gives it the criterions, architectures and defaults of the nearest task
  it derives from (a subclass of `tasks.dummy.DummyVAETask` trains as
  dummy_vae does);
* `register_criterion(name)`: a class built as `cls(args, task)` into
  `criterions.aliases.CRITERIONS`, accepted for any task;
* `register_architecture(base, name)`: a function that sets width
  defaults in the arguments' dict, into the table of the existing
  architecture `base`, whose defaults then fill the rest.

`import_user_module` runs a path once; it raises FileNotFoundError for a
missing path and FileExistsError where the module's name is one already
imported (whose registrations would otherwise never run).
"""

from __future__ import annotations

import importlib
import os
import sys
from typing import Callable, Dict, Optional

from diffnorm_tpu_torch.criterions.aliases import CRITERIONS
from diffnorm_tpu_torch.tasks import TASKS

USER_CRITERIONS: set = set()
# a registered architecture -> the existing one whose model it builds
ARCH_BASES: Dict[str, str] = {}
_user_modules: set = set()


def _add(table: dict, kind: str, name: str, obj) -> None:
    if name in table:
        raise ValueError(f"{kind} '{name}' already registered")
    table[name] = obj


def register_task(name: str):
    def wrapper(cls):
        _add(TASKS, "task", name, cls)
        return cls
    return wrapper


def register_criterion(name: str):
    def wrapper(cls):
        _add(CRITERIONS, "criterion", name, cls)
        USER_CRITERIONS.add(name)
        return cls
    return wrapper


def _arch_tables():
    from diffnorm_tpu_torch.models.ar_transformer import ARCHS as AR
    from diffnorm_tpu_torch.models.cmlm_text import ARCHS as CMLM
    from diffnorm_tpu_torch.models.diffusion import ARCHS as DIFFUSION
    from diffnorm_tpu_torch.models.hubert import CTC_ARCHS, PRETRAIN_ARCHS
    from diffnorm_tpu_torch.models.levenshtein import ARCHS as LEV
    from diffnorm_tpu_torch.models.nar_transformer import ARCHS as NAR
    from diffnorm_tpu_torch.models.s2t_transformer import ARCHS as S2T
    from diffnorm_tpu_torch.models.sedd import ARCHS as SEDD
    from diffnorm_tpu_torch.models.transformer_text import ARCHS as MT
    from diffnorm_tpu_torch.models.unit_lm import ARCHS as LM
    from diffnorm_tpu_torch.models.unity import ARCHS as UNITY
    from diffnorm_tpu_torch.models.wav2vec2 import ARCHS as W2V
    from diffnorm_tpu_torch.tasks.s2spect_task import ARCHS as SPECT
    from diffnorm_tpu_torch.tasks.tts_task import ARCHS as TTS

    return (AR, CMLM, DIFFUSION, CTC_ARCHS, PRETRAIN_ARCHS, LEV, NAR, S2T, SEDD, MT, LM, UNITY,
            W2V, SPECT, TTS)


def register_architecture(base: str, name: str):
    """fn(widths: dict) sets `name`'s defaults where they are None; then
    `base`'s fill the rest."""
    def wrapper(fn: Callable[[dict], None]):
        tables = [t for t in _arch_tables() if base in t]
        if not tables:
            raise KeyError(f"register_architecture: no architecture '{base}'")
        base_fn = tables[0][base]

        def stamp(widths: dict) -> None:
            fn(widths)
            base_fn(widths)

        for table in tables:
            _add(table, "architecture", name, stamp)
        ARCH_BASES[name] = ARCH_BASES.get(base, base)
        return fn
    return wrapper


def import_user_module(module_path: Optional[str]) -> None:
    """Import the package or .py module at `module_path` so its register_*
    calls run (--user-dir); nothing for None, once per path."""
    if not module_path:
        return
    module_path = os.path.abspath(str(module_path))
    if not os.path.exists(module_path):
        raise FileNotFoundError(f"--user-dir not found: {module_path}")
    if module_path in _user_modules:
        return
    parent, name = os.path.split(module_path)
    if name.endswith(".py"):
        name = name[:-3]
    if name in sys.modules:
        raise FileExistsError(
            f"--user-dir module name '{name}' collides with an already-imported module "
            f"({sys.modules[name]}); rename the user directory")
    _user_modules.add(module_path)
    sys.path.insert(0, parent)
    try:
        importlib.import_module(name)
    finally:
        if sys.path and sys.path[0] == parent:
            sys.path.pop(0)
