"""Helpers of the port's script tests: the repository's scripts that drive
the JAX package, loaded with importlib, and the flags of an argparse
parser (the port's ``build_parser()`` or the one a JAX script's ``main``
builds)."""

from __future__ import annotations

import argparse
import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name: str):
    """``scripts/<name>`` as a module (its ``main`` not run)."""
    path = os.path.join(REPO, "scripts", name)
    spec = importlib.util.spec_from_file_location("jax_" + name[:-3].replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flags(parser: argparse.ArgumentParser) -> set[str]:
    """The option strings of ``parser`` and the names of its positionals."""
    return {s for a in parser._actions for s in a.option_strings} | {
        a.dest for a in parser._actions if not a.option_strings}


class _Parsed(Exception):
    pass


def jax_parser(mod, monkeypatch) -> argparse.ArgumentParser:
    """The parser a JAX script's ``main`` builds (caught at ``parse_args``)."""
    seen = []

    def capture(self, *a, **k):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        mod.main([]) if mod.main.__code__.co_argcount else mod.main()
    monkeypatch.undo()
    return seen[0]
