"""Minimal hydra-style config system: YAML files + dotted CLI overrides
(the port's own copy of ``depthg_tpu/config.py``).

Mirrors the reference's config surface (hydra + OmegaConf with
``set_struct(cfg, False)``, see reference ``src/train_segmentation.py:550-552``
and ``src/utils.py:148-161`` ``prep_args``) without depending on hydra/omegaconf:

* ``Config`` is a dict with attribute access; missing attributes raise
  ``AttributeError`` (so reference-style ``try: cfg.foo except: ...`` works) and
  new keys may be assigned at any time (struct-free semantics).
* ``load_config(name_or_path, overrides)`` loads a YAML from
  ``depthg_tpu_torch/configs`` (or an absolute path) and applies ``key=value`` /
  ``key.sub=value`` overrides with YAML-typed values.
* ``cli_overrides(argv)`` accepts both ``k=v`` and ``--k v`` argument styles,
  like the reference's ``prep_args``.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Iterable

import yaml

_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")


class _Loader(yaml.SafeLoader):
    """SafeLoader that also parses ``5e-4``-style floats (YAML 1.2 / omegaconf
    behavior; plain pyyaml would return the string)."""


_Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def _yaml_load(text: str) -> Any:
    return yaml.load(text, Loader=_Loader)


class Config(dict):
    """Attribute-accessible dict. Nested dicts are wrapped on the fly."""

    def __getattr__(self, name: str) -> Any:
        try:
            val = self[name]
        except KeyError:
            raise AttributeError(name) from None
        if isinstance(val, dict) and not isinstance(val, Config):
            val = Config(val)
            self[name] = val
        return val

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node: dict = self
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                nxt = Config()
                node[part] = nxt
            node = nxt
        node[parts[-1]] = value

    def copy(self) -> "Config":
        return Config(copy.deepcopy(dict(self)))

    def to_yaml(self) -> str:
        return yaml.safe_dump(_plain(self), sort_keys=False)


def _plain(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return Config({k: _wrap(v) for k, v in obj.items()})
    return obj


def _parse_value(text: str) -> Any:
    """YAML-typed scalar parsing so ``lr=5e-4`` and ``lhp=False`` do the right thing."""
    try:
        return _yaml_load(text)
    except yaml.YAMLError:
        return text


def cli_overrides(argv: Iterable[str]) -> list[str]:
    """Normalize ``--key value`` and ``key=value`` argv styles to ``key=value``.

    Same behavior as reference ``src/utils.py:148-161`` (``prep_args``).
    """
    out: list[str] = []
    args = list(argv)
    while args:
        arg = args.pop(0)
        if len(arg.split("=", 1)) == 2 and not arg.startswith("--"):
            out.append(arg)
        elif arg.startswith("--"):
            if not args:
                raise ValueError(f"Flag {arg} is missing a value")
            out.append(arg[2:] + "=" + args.pop(0))
        else:
            raise ValueError(f"Unexpected arg style {arg}")
    return out


def apply_overrides(cfg: Config, overrides: Iterable[str]) -> Config:
    for item in overrides:
        key, _, raw = item.partition("=")
        cfg.set_path(key.strip(), _parse_value(raw))
    return cfg


def load_config(name_or_path: str, overrides: Iterable[str] = ()) -> Config:
    path = name_or_path
    if not os.path.exists(path):
        cand = os.path.join(_CONFIG_DIR, name_or_path)
        if not cand.endswith((".yml", ".yaml")):
            cand += ".yml"
        path = cand
    with open(path) as f:
        cfg = _wrap(_yaml_load(f.read()) or {})
    return apply_overrides(cfg, overrides)
