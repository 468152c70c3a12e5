"""safe arithmetic-expression evaluation.

The port's own copy of newton_krylov_ooc_tpu/utils/helpers.py::eval_expr:
model parameters in cfg files may be written as expressions such as
"1.0 / (365.0 * 86400.0)".
"""

from __future__ import annotations

import ast
import operator

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
