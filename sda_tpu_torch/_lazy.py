"""``torch``, imported at its first use.

Importing torch costs a process seconds and gigabytes on a card's host.
The server and the commands of ``sda`` that do no device work (identities,
create, begin, end, ping) never touch a tensor, so the modules they load
bind ``torch`` to this proxy in place of the module: the first attribute
read imports torch, and each attribute read once is kept on the proxy, so
later reads cost what a module's do.
"""

from __future__ import annotations

import importlib

__all__ = ["torch"]


class _Torch:
    """Stands for the ``torch`` module; reading an attribute imports it."""

    def __getattr__(self, name: str):
        value = getattr(importlib.import_module("torch"), name)
        setattr(self, name, value)
        return value


torch = _Torch()
