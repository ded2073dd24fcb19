"""Hydra-style config composition (YAML, no dependencies beyond PyYAML).

The port's own copy of ``matcha_tpu/utils/config.py``'s ``compose`` and
its helpers, reading the repo's ``configs/`` tree:

* a root config with a ``defaults`` list naming config groups
  (``data: ljspeech`` loads configs/data/ljspeech.yaml under key ``data``);
* group selection from the command line (``experiment=ljspeech``,
  ``debug=fdr``);
* dotted overrides (``model.decoder.channels=[256,256]``,
  ``trainer.max_steps=10``);
* ``${a.b}`` interpolation across the composed tree;
* ``# @package _global_`` files that override at the root;

and its ``format_config_tree`` / ``print_config_tree``, the text the
training entry point prints and writes to ``config_tree.log``.

``_target_`` keys name the JAX package's classes; the port ignores them.
"""

import ast
import os
import re
from typing import Any, Dict, List, Optional

import yaml

_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


class DotDict(dict):
    """dict with attribute access and .get chaining."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    __setattr__ = dict.__setitem__


def _to_dotdict(x):
    if isinstance(x, dict):
        return DotDict({k: _to_dotdict(v) for k, v in x.items()})
    if isinstance(x, list):
        return [_to_dotdict(v) for v in x]
    return x


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _load_yaml(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        text = f.read()
    data = yaml.safe_load(text) or {}
    data["__package_global__"] = "@package _global_" in text.splitlines()[0] if text else False
    return data


def _resolve_group_file(config_dir: str, group: str, name: str) -> str:
    for cand in (f"{name}.yaml", f"{name}.yml", name):
        p = os.path.join(config_dir, group, cand)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"Config group file not found: {group}/{name} under {config_dir}")


def _compose_file(config_dir: str, group: str, name: str) -> dict:
    """Load a group file, recursively applying its own defaults list."""
    path = _resolve_group_file(config_dir, group, name)
    data = _load_yaml(path)
    data.pop("__package_global__", None)
    defaults = data.pop("defaults", None)
    merged: dict = {}
    if defaults:
        for entry in defaults:
            if entry == "_self_":
                merged = _deep_merge(merged, data)
                data = {}
            elif isinstance(entry, str):
                merged = _deep_merge(merged, _compose_file(config_dir, group, entry))
            elif isinstance(entry, dict):
                for sub_group, sub_name in entry.items():
                    if sub_name is None:
                        continue
                    sub = _compose_file(config_dir, f"{group}/{sub_group}", sub_name)
                    merged = _deep_merge(merged, {sub_group: sub})
    merged = _deep_merge(merged, data)
    return merged


def _parse_value(s: str) -> Any:
    if isinstance(s, str):
        low = s.strip()
        if low.lower() in ("null", "none", "~"):
            return None
        if low.lower() == "true":
            return True
        if low.lower() == "false":
            return False
        try:
            return ast.literal_eval(low)
        except (ValueError, SyntaxError):
            pass
        # Hydra-style bare-word lists: [a,b,c]
        if low.startswith("[") and low.endswith("]"):
            items = [x.strip() for x in low[1:-1].split(",") if x.strip()]
            return [_parse_value(x) for x in items]
        return s
    return s


def _set_dotted(cfg: dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            node[p] = {}
        node = node[p]
    node[parts[-1]] = value


def _get_dotted(cfg: dict, dotted: str):
    node = cfg
    for p in dotted.split("."):
        node = node[p]
    return node


def _interpolate(cfg: dict) -> dict:
    """Resolve ${a.b} references (iterate to handle chains)."""

    def resolve(value, root, depth=0):
        if depth > 10:
            return value
        if isinstance(value, str):
            m = _INTERP_RE.fullmatch(value.strip())
            if m:
                try:
                    return resolve(_get_dotted(root, m.group(1)), root, depth + 1)
                except (KeyError, TypeError):
                    return value

            def sub(mm):
                try:
                    v = resolve(_get_dotted(root, mm.group(1)), root, depth + 1)
                except (KeyError, TypeError):
                    return mm.group(0)
                return str(v)

            return _INTERP_RE.sub(sub, value)
        if isinstance(value, dict):
            return {k: resolve(v, root, depth) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v, root, depth) for v in value]
        return value

    return resolve(cfg, cfg)


def compose(
    config_name: str = "train",
    overrides: Optional[List[str]] = None,
    config_dir: Optional[str] = None,
) -> DotDict:
    """Compose a config like ``hydra.compose``.

    Args:
        config_name: root yaml (without extension) in ``config_dir``.
        overrides: list of "group=name" selections and "a.b=v" overrides.
        config_dir: defaults to <repo>/configs.
    """
    if config_dir is None:
        config_dir = os.environ.get(
            "MATCHA_CONFIG_DIR",
            os.path.join(os.path.dirname(__file__), "..", "..", "configs"),
        )
    config_dir = os.path.abspath(config_dir)
    overrides = list(overrides or [])

    root_path = os.path.join(config_dir, f"{config_name}.yaml")
    root = _load_yaml(root_path)
    root.pop("__package_global__", None)
    defaults = root.pop("defaults", [])

    # Split overrides into group selections vs dotted value overrides.
    group_sel: Dict[str, str] = {}
    dotted: List[tuple] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must be key=value: {ov!r}")
        k, v = ov.split("=", 1)
        if "." not in k and os.path.isdir(os.path.join(config_dir, k)):
            group_sel[k] = v
        else:
            dotted.append((k, _parse_value(v)))

    cfg: dict = {}
    self_done = False
    for entry in defaults:
        if entry == "_self_":
            cfg = _deep_merge(cfg, root)
            self_done = True
            continue
        if isinstance(entry, str):
            continue  # e.g. "optional local: default" handled below
        for group, name in entry.items():
            optional = False
            if group.startswith("optional "):
                group = group[len("optional "):]
                optional = True
            name = group_sel.pop(group, name)
            if name is None:
                continue
            try:
                sub = _compose_file(config_dir, group, name)
            except FileNotFoundError:
                if optional:
                    continue
                raise
            if sub.pop("__global__", False) or _is_global(config_dir, group, name):
                cfg = _deep_merge(cfg, sub)
            else:
                cfg = _deep_merge(cfg, {group: sub})
    if not self_done:
        cfg = _deep_merge(cfg, root)

    # Remaining group selections not named in defaults (e.g. experiment=x
    # when the root default was null).
    for group, name in group_sel.items():
        sub = _compose_file(config_dir, group, name)
        if _is_global(config_dir, group, name):
            cfg = _deep_merge(cfg, sub)
        else:
            cfg = _deep_merge(cfg, {group: sub})

    for k, v in dotted:
        _set_dotted(cfg, k, v)

    cfg = _interpolate(cfg)
    return _to_dotdict(cfg)


def _is_global(config_dir: str, group: str, name: str) -> bool:
    try:
        path = _resolve_group_file(config_dir, group, name)
    except FileNotFoundError:
        return False
    with open(path, encoding="utf-8") as f:
        first = f.readline()
    return "@package _global_" in first


#: the reference's branch print order (rich_utils.print_config_tree)
_PRINT_ORDER = ("data", "model", "callbacks", "logger", "trainer", "paths", "extras")


def format_config_tree(cfg: dict, print_order=_PRINT_ORDER) -> str:
    """The composed config as a guided tree with yaml branch bodies,
    ``print_order``'s fields first and the rest after."""
    queue = [f for f in print_order if f in cfg]
    queue += [f for f in cfg if f not in queue]
    lines = ["CONFIG"]
    for n, field in enumerate(queue):
        last = n == len(queue) - 1
        lines.append(("└── " if last else "├── ") + str(field))
        body = cfg[field]
        body_str = (yaml.safe_dump(_plain(body), sort_keys=False).rstrip()
                    if isinstance(body, dict) else str(body))
        pad = "    " if last else "│   "
        lines += [pad + ln for ln in body_str.splitlines()]
    return "\n".join(lines)


def print_config_tree(cfg: dict, save_to_file: bool = False) -> None:
    """Print the config tree and, with ``save_to_file``, write it to
    ``<paths.output_dir>/config_tree.log``."""
    text = format_config_tree(cfg)
    print(text)
    out_dir = cfg.get("paths", {}).get("output_dir")
    if save_to_file and out_dir:
        # extras() runs before the task creates the run directory
        os.makedirs(str(out_dir), exist_ok=True)
        with open(os.path.join(str(out_dir), "config_tree.log"), "w",
                  encoding="utf-8") as f:
            f.write(text + "\n")


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x if isinstance(x, (str, int, float, bool, type(None))) else str(x)


def save_config(cfg: dict, path: str) -> None:
    def plain(x):
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, list):
            return [plain(v) for v in x]
        return x

    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(plain(cfg), f, sort_keys=False)
