"""Configs: jinja2-templated YAML with command-line flags made from the
template's variables.

Counterpart of ``ultra_tpu/utils/config.py`` (``util.py:25-65`` of the
reference): every undeclared ``{{ var }}`` of the YAML template becomes a
flag, and values parse with ``ast.literal_eval``, so ``--gpus [0,1]`` or
``--bpe null`` work. jinja2 and PyYAML are imported where they are used, so
the package imports without them.
"""

from __future__ import annotations

import argparse
import ast
from typing import Tuple


class AttrDict(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @classmethod
    def wrap(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.wrap(v) for v in obj]
        return obj


def detect_variables(cfg_file: str):
    """Undeclared jinja2 template variables (``util.py:25-32``)."""
    import jinja2
    from jinja2 import meta

    with open(cfg_file) as f:
        return meta.find_undeclared_variables(jinja2.Environment().parse(f.read()))


def load_config(cfg_file: str, context: dict | None = None) -> AttrDict:
    """Render the template with ``context`` and parse the YAML
    (``util.py:34-41``)."""
    import jinja2
    import yaml

    with open(cfg_file) as f:
        template = jinja2.Template(f.read())
    return AttrDict.wrap(yaml.safe_load(template.render(context or {})))


def parse_args(
    parser: argparse.ArgumentParser | None = None,
    optional_vars: bool = False,
) -> Tuple[argparse.Namespace, dict]:
    """-c/--config, -s/--seed plus a flag for each template variable
    (``util.py:44-65``). ``optional_vars``: the variables' flags are optional
    (an unset one renders empty, which YAML reads as null), for command lines
    that reuse training configs but never read ``train.*``."""
    parser = parser or argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True, help="yaml config file")
    parser.add_argument("-s", "--seed", type=int, default=1024, help="random seed")
    args, unparsed = parser.parse_known_args()

    var_parser = argparse.ArgumentParser()
    for var in sorted(detect_variables(args.config)):
        var_parser.add_argument(f"--{var}", required=not optional_vars,
                                **({"default": None} if optional_vars else {}))
    vars_dict = {}
    for k, v in vars(var_parser.parse_args(unparsed)).items():
        if v is None:
            continue
        try:
            vars_dict[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            vars_dict[k] = v
    return args, vars_dict
