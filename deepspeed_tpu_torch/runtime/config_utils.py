"""Shared machinery of the port's config blocks.

Counterpart of ``deepspeed_tpu/runtime/config_utils.py``, on plain
``dataclasses`` instead of pydantic.  As in the JAX ``ConfigModel``:
unknown keys are rejected, a ``None`` value means "use the default", and
a value of the wrong type raises ``ValueError`` (pydantic's lax scalar
coercion: integral floats and numeric strings for ints, numbers and
numeric strings for floats, 0/1 and yes/no-style strings for bools).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union, get_type_hints

AUTO = "auto"

_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


def _coerce(value: Any, hint: Any) -> Any:
    """Raises ValueError (or TypeError) on a value ``hint`` refuses."""
    if hint is str:
        if not isinstance(value, str):
            raise TypeError("expected a string")
        return value
    if hint is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, int) and value in (0, 1):
            return bool(value)
        if isinstance(value, str) and value.lower() in _TRUE | _FALSE:
            return value.lower() in _TRUE
        raise ValueError("expected a boolean")
    if isinstance(value, bool) or not isinstance(value, (int, float, str)):
        raise TypeError(f"expected {hint.__name__}")
    if hint is float:
        return float(value)
    if isinstance(value, float) and not value.is_integer():
        raise ValueError("expected an integer, got a fractional number")
    return int(float(value)) if isinstance(value, float) else int(value)


def _check_type(path: str, value: Any, hint: Any) -> Any:
    origin = getattr(hint, "__origin__", None)
    if origin is Union:                        # Optional[X]
        args = [a for a in hint.__args__ if a is not type(None)]
        return _check_type(path, value, args[0])
    try:
        return _coerce(value, hint)
    except (TypeError, ValueError) as e:
        raise ValueError(f"{path}: {e}, got {type(value).__name__} "
                         f"{value!r}") from None


def from_dict(cls, data: Optional[Dict[str, Any]], path: str):
    """Build config dataclass ``cls`` from the JSON block at ``path``."""
    if data is None:
        return cls()
    if isinstance(data, cls):
        return data
    if not isinstance(data, dict):
        raise ValueError(f"{path or 'config'}: expected a JSON object, "
                         f"got {type(data).__name__}")
    hints = get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - names)
    if unknown:
        raise ValueError(f"{path or 'config'}: unknown key(s) {unknown} "
                         f"(extra keys are forbidden)")
    kw = {}
    for name, value in data.items():
        if value is None:                      # None = keep the default
            continue
        hint = hints[name]
        sub = f"{path}.{name}" if path else name
        if getattr(hint, "__origin__", None) is Union:
            args = [a for a in hint.__args__ if a is not type(None)]
            if len(args) == 1 and dataclasses.is_dataclass(args[0]):
                hint = args[0]             # Optional[block]: given = built
        if dataclasses.is_dataclass(hint):
            kw[name] = from_dict(hint, value, sub)
        elif (hint is Any or hint == Optional[Dict[str, Any]]
              or hint == Dict[str, Any]):
            kw[name] = value
        else:
            kw[name] = _check_type(sub, value, hint)
    return cls(**kw)


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """``json.load`` object_pairs_hook that rejects duplicate keys."""
    d = dict(ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter: dict = {}
        for k, _ in ordered_pairs:
            counter[k] = counter.get(k, 0) + 1
        dupes = [k for k, n in counter.items() if n > 1]
        raise ValueError(f"Duplicate keys in config: {dupes}")
    return d
