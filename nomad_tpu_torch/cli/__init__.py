"""CLI (reference: command/ — ~140 subcommands; the core set here).

Port of ``nomad_tpu/cli/__init__.py``.
"""

from .main import main

__all__ = ["main"]
