"""The field encodings of the plain reference, one module a name: the
configuration's ``grid.enc`` names ``encodings/<enc>.py``, read as the
port reads it (``FieldConfig.from_dict``: a grid block without ``enc`` is
a HashGrid field).

A module gives:

- ``spec(cfg)``: the encoding's widths from a system configuration, a
  hashable value;
- ``embed_leaves(params)``: the embed group's leaves of a parameter tree
  as ``[(name, tensor)]``, in the port's ``Field.embed_params()`` order
  (the names the map optimizer's moments are kept under);
- ``encode(params, x, spec)``: points ``[N, 3]`` -> ``[N, E]``, with the
  gradient to the points that the encoding defines.

A new encoding is a new file here; nothing else of the reference names
one.
"""

from __future__ import annotations

import importlib
import os
from typing import Dict

DIR = os.path.dirname(os.path.abspath(__file__))
DEFAULT = "HashGrid"


def name_of(cfg: Dict) -> str:
    """The encoding a system configuration names."""
    return cfg["grid"].get("enc", DEFAULT)


def file_of(name: str) -> str:
    return os.path.join(DIR, f"{name}.py")


def load(name: str):
    """The module of encoding ``name``; FileNotFoundError naming its file
    where the reference has none."""
    if not os.path.exists(file_of(name)):
        raise FileNotFoundError(file_of(name))
    return importlib.import_module(f"{__name__}.{name}")
