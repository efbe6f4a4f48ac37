"""Tiny function-signature CLI (stand-in for tyro, which the reference
uses on every entry point). Counterpart: ``tpugs/utils/cli.py``.

``cli(fn)`` builds an argparse parser from ``fn``'s signature: parameter
names become ``--kebab-case`` flags, annotations give types, defaults
give defaults; bools become ``--flag/--no-flag`` pairs.
"""

from __future__ import annotations

import argparse
import inspect
import typing


def _base_type(ann):
    origin = typing.get_origin(ann)
    if origin is typing.Literal:
        return type(typing.get_args(ann)[0]), list(typing.get_args(ann))
    if origin in (typing.Union, getattr(typing, "UnionType", None)):
        args = [a for a in typing.get_args(ann) if a is not type(None)]
        if args:
            return _base_type(args[0])
    if ann in (int, float, str, bool):
        return ann, None
    return str, None


def cli(fn, argv=None):
    sig = inspect.signature(fn)
    doc = inspect.getdoc(fn) or ""
    # Resolve string annotations (`from __future__ import annotations`
    # makes every annotation a string, which would otherwise defeat the
    # bool/choices handling).
    try:
        hints = typing.get_type_hints(fn)
    except (NameError, TypeError):
        hints = {}
    parser = argparse.ArgumentParser(description=doc.splitlines()[0] if doc else None)
    for name, param in sig.parameters.items():
        flag = "--" + name.replace("_", "-")
        ann = hints.get(
            name,
            param.annotation
            if param.annotation is not inspect.Parameter.empty
            else str,
        )
        typ, choices = _base_type(ann)
        default = None if param.default is inspect.Parameter.empty else param.default
        required = param.default is inspect.Parameter.empty
        if typ is bool:
            parser.add_argument(
                flag,
                dest=name,
                action=argparse.BooleanOptionalAction,
                default=default,
            )
        else:
            parser.add_argument(
                flag,
                dest=name,
                type=typ,
                choices=choices,
                default=default,
                required=required,
            )
    args = parser.parse_args(argv)
    return fn(**vars(args))
