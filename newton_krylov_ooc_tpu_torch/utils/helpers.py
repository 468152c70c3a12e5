"""general-purpose helpers (dict/metadata utilities, safe expression eval,
subclass discovery, string formatting)

Capability parity with nk_ooc/utils.py:22-164.  The port's own copy of
newton_krylov_ooc_tpu/utils/helpers.py; model parameters in cfg files may be
written as expressions such as "1.0 / (365.0 * 86400.0)" (eval_expr).
"""

from __future__ import annotations

import ast
import importlib
import inspect
import logging
import operator

import numpy as np


def attr_common(metadata_dict: dict, attr_name: str):
    """
    common value of attrs[attr_name] across all entries of metadata_dict, or None
    if the attribute is missing anywhere or values differ
    """
    if not isinstance(metadata_dict, dict):
        raise TypeError(f"metadata_dict must be a dict, not {type(metadata_dict)}")
    vals = []
    for metadata in metadata_dict.values():
        attrs = metadata.get("attrs", {})
        if attr_name not in attrs:
            return None
        vals.append(attrs[attr_name])
    if not vals:
        return None
    first = vals[0]
    return first if all(val == first for val in vals[1:]) else None


def dict_sel(dict_obj: dict, **kwargs) -> dict:
    """subset of dict_obj whose dict-values match all (key, value) pairs in kwargs"""
    if not isinstance(dict_obj, dict):
        raise TypeError(f"dict_obj must be a dict, not {type(dict_obj)}")
    res = dict_obj
    for sel_key, sel_value in kwargs.items():
        res = {
            key: value
            for key, value in res.items()
            if isinstance(value, dict) and value.get(sel_key, None) == sel_value
        }
    return res


def dict_update_verify(dict_in: dict, dict_add: dict) -> dict:
    """merge dict_add into dict_in, raising if an existing key maps to a
    different value"""
    for key, value_add in dict_add.items():
        if key not in dict_in:
            dict_in[key] = value_add
            continue
        existing = dict_in[key]
        if isinstance(value_add, np.ndarray) or isinstance(existing, np.ndarray):
            if np.any(np.asarray(existing) != np.asarray(value_add)):
                raise RuntimeError(f"dict value mismatch for key={key}")
        elif existing != value_add:
            raise RuntimeError(f"dict value mismatch for key={key}")
    return dict_in


def class_name(obj) -> str:
    """module-qualified class name of obj"""
    return f"{obj.__module__}.{type(obj).__name__}"


def get_subclasses(mod_name: str, base_class) -> list:
    """subclasses of base_class defined in module mod_name (empty if unimportable)"""
    logger = logging.getLogger(__name__)
    try:
        mod = importlib.import_module(mod_name)
    except ModuleNotFoundError:
        logger.debug("module %s not found", mod_name)
        return []
    return [
        value
        for (_, value) in inspect.getmembers(mod, inspect.isclass)
        if issubclass(value, base_class) and value is not base_class
    ]


def fmt_vals(var, fmt: dict):
    """recursively apply str.format substitutions to all strings in var"""
    if isinstance(var, str):
        return var.format(**fmt)
    if isinstance(var, list):
        return [fmt_vals(item, fmt) for item in var]
    if isinstance(var, tuple):
        return tuple(fmt_vals(item, fmt) for item in var)
    if isinstance(var, set):
        return {fmt_vals(item, fmt) for item in var}
    if isinstance(var, dict):
        return {fmt_vals(key, fmt): fmt_vals(val, fmt) for key, val in var.items()}
    return var


def strtobool(val: str) -> int:
    """convert a string representation of truth to 1/0"""
    val = val.lower()
    if val in ("y", "yes", "t", "true", "on", "1"):
        return 1
    if val in ("n", "no", "f", "false", "off", "0"):
        return 0
    raise ValueError(f"invalid truth value {val!r}")


_EVAL_OPERATORS = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.Pow: operator.pow,
    ast.UAdd: operator.pos,
    ast.USub: operator.neg,
}


def eval_expr(expr: str):
    """safely evaluate an arithmetic expression (AST-restricted, no names/calls)"""
    return _eval_node(ast.parse(expr, mode="eval").body)


def _eval_node(node):
    if isinstance(node, ast.Constant):
        if not isinstance(node.value, (int, float)):
            raise TypeError(node)
        return node.value
    if isinstance(node, ast.BinOp):
        return _EVAL_OPERATORS[type(node.op)](
            _eval_node(node.left), _eval_node(node.right)
        )
    if isinstance(node, ast.UnaryOp):
        return _EVAL_OPERATORS[type(node.op)](_eval_node(node.operand))
    raise TypeError(node)
