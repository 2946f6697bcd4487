"""Model families, found by the name a configuration's file gives: each
module ``<family>.py`` builds the program's model (``port``) and the
reference's (``reference``) on the meta device from the same arguments,
and names the buffers that are given rather than drawn (``fixed``)."""
from __future__ import annotations

import importlib


def family(name: str):
    return importlib.import_module(f"gpubench.models.{name}")
