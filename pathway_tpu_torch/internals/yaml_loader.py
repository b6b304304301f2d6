"""YAML pipeline loader (reference
``python/pathway/internals/yaml_loader.py`` — used by the app templates).

Copy of ``pathway_tpu/internals/yaml_loader.py``. ``!pw.some.dotted.Name`` tags instantiate the
referenced callable with the mapping's entries as kwargs; ``$ref: name`` entries resolve to
previously defined top-level objects, and ``$env`` interpolates environment variables.

Where the reference maps the ``pw.`` prefix to ``pathway_tpu``, this copy maps it to
``pathway_tpu_torch``, and so it does ``pathway_tpu.``: a tag never imports the JAX package. A
class the port renamed resolves to its counterpart through ``RENAMED``, one table of dotted paths
under the package:

- ``xpacks.llm.embedders.TpuEmbedder`` -> ``xpacks.llm.embedders.TorchEmbedder``

so one YAML builds the same pipeline in both packages. A tag under ``jax`` or ``jaxlib`` raises
``ImportError``: the loader is the port's one import by name, and it never imports JAX. PyYAML
is imported when a YAML is loaded, not with the package.
"""

from __future__ import annotations

import functools
import importlib
import os
from typing import Any, IO

__all__ = ["load_yaml"]

PACKAGE = "pathway_tpu_torch"

#: the reference's name under the package -> the port's counterpart
RENAMED = {
    "xpacks.llm.embedders.TpuEmbedder": "xpacks.llm.embedders.TorchEmbedder",
}

#: top-level modules a tag may not name
REFUSED = ("jax", "jaxlib")


def _resolve_dotted(path: str) -> Any:
    for prefix in ("pw", "pathway_tpu"):
        if path == prefix or path.startswith(prefix + "."):
            rest = path[len(prefix) + 1:]
            path = PACKAGE + ("." + RENAMED.get(rest, rest) if rest else "")
            break
    parts = path.split(".")
    if parts[0] in REFUSED:
        raise ImportError(f"cannot resolve {path!r}: the port imports no JAX")
    for split in range(len(parts), 0, -1):
        module_name = ".".join(parts[:split])
        try:
            obj: Any = importlib.import_module(module_name)
        except ImportError:
            continue
        for attr in parts[split:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(f"cannot resolve {path!r}")


class _Tagged:
    def __init__(self, path: str, value: Any):
        self.path = path
        self.value = value


@functools.cache
def _loader() -> type:
    import yaml

    class _Loader(yaml.SafeLoader):
        pass

    def _tag_constructor(loader: _Loader, tag_suffix: str, node: yaml.Node) -> _Tagged:
        if isinstance(node, yaml.MappingNode):
            value = loader.construct_mapping(node, deep=True)
        elif isinstance(node, yaml.SequenceNode):
            value = loader.construct_sequence(node, deep=True)
        else:
            value = loader.construct_scalar(node)
        return _Tagged(tag_suffix, value)

    _Loader.add_multi_constructor("!", _tag_constructor)
    return _Loader


def _instantiate(obj: Any, defined: dict[str, Any]) -> Any:
    if isinstance(obj, _Tagged):
        target = _resolve_dotted(obj.path)
        value = _instantiate(obj.value, defined)
        if isinstance(value, dict):
            return target(**value)
        if value is None or (isinstance(value, str) and value == ""):
            return target()
        if isinstance(value, list):
            return target(*value)
        return target(value)
    if isinstance(obj, dict):
        if set(obj.keys()) == {"$ref"}:
            return defined[obj["$ref"]]
        if set(obj.keys()) == {"$env"}:
            return os.environ[obj["$env"]]
        return {k: _instantiate(v, defined) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_instantiate(v, defined) for v in obj]
    if isinstance(obj, str) and obj.startswith("$") and len(obj) > 1:
        # $name references a defined entry; an unknown name is an error
        # (reference test_yaml.py:96), never a silent literal
        if obj[1:] not in defined:
            raise KeyError(f"undefined yaml variable {obj!r}")
        return defined[obj[1:]]
    return obj


def load_yaml(stream: str | IO) -> Any:
    """Parse a YAML pipeline description, instantiating ``!dotted.path``
    tags (top-level keys become ``$name`` references for later entries)."""
    import yaml

    raw = yaml.load(stream, Loader=_loader())
    if not isinstance(raw, dict):
        return _instantiate(raw, {})
    defined: dict[str, Any] = {}
    out: dict[str, Any] = {}
    for key, value in raw.items():
        if isinstance(key, str) and key.startswith("$"):
            # ``$name:`` defines a variable — referenced as ``$name``,
            # excluded from the result (reference test_yaml.py:58)
            defined[key[1:]] = _instantiate(value, defined)
        else:
            v = _instantiate(value, defined)
            defined[key] = v
            out[key] = v
    return out
