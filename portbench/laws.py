"""Hardening laws given as text in a cell's file.

A law is an expression of the equivalent plastic strain ``p`` built from
numbers, ``+ - * / **`` and the functions ``exp``, ``log``, ``sqrt`` and
``tanh``: ``"350.0 + 2e3 * p + 50.0 * tanh(100.0 * p)"``. :func:`compile_law`
checks it against that grammar and returns a plain callable of a tensor,
which the program receives as its user law and the reference evaluates on
its own.
"""

from __future__ import annotations

import ast

import torch

FUNCTIONS = {"exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt, "tanh": torch.tanh}
_NODES = (ast.Expression, ast.BinOp, ast.UnaryOp, ast.Call, ast.Name, ast.Load, ast.Constant,
          ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow, ast.USub, ast.UAdd)


def parse(text: str) -> ast.Expression:
    tree = ast.parse(text, mode="eval")
    for node in ast.walk(tree):
        if not isinstance(node, _NODES):
            raise ValueError(f"law {text!r}: {type(node).__name__} is not allowed")
        if isinstance(node, ast.Name) and node.id != "p" and node.id not in FUNCTIONS:
            raise ValueError(f"law {text!r}: unknown name {node.id!r}")
        if isinstance(node, ast.Call) and not (isinstance(node.func, ast.Name) and node.func.id in FUNCTIONS):
            raise ValueError(f"law {text!r}: only {sorted(FUNCTIONS)} may be called")
        if isinstance(node, ast.Constant) and not isinstance(node.value, (int, float)):
            raise ValueError(f"law {text!r}: constants are numbers")
    return tree


def compile_law(text: str):
    """``law(p) -> sigma_Y`` for the expression ``text``."""
    code = compile(parse(text), f"<law {text}>", "eval")

    def law(p):
        return eval(code, {"__builtins__": {}, **FUNCTIONS}, {"p": p})

    law.text = text
    return law


def operation_count(text: str) -> int:
    """Arithmetic operations and function calls in the expression."""
    return sum(isinstance(n, (ast.BinOp, ast.UnaryOp, ast.Call)) for n in ast.walk(parse(text)))
