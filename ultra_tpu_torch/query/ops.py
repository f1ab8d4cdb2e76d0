"""Logical-query programs in postfix form, as packed int64 opcodes.

Counterpart of ``ultra_tpu/query/ops.py`` (numpy, a copy rather than an
import): the reference's ``Query`` tensor subclass (``query_utils.py:13-195``)
as host arrays. Opcode bits: projection 1<<58, intersection 1<<59, union
1<<60, negation 1<<61, stop 1<<62; the operand (an entity or relation id)
in the low bits, so ids stay below 2**58. Keep programs int64 until
:func:`decompose` splits them into an op kind (int8) and an operand (int32):
any earlier cast to int32 drops the opcode bits.
"""


from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

PROJECTION = 1 << 58
INTERSECTION = 1 << 59
UNION = 1 << 60
NEGATION = 1 << 61
STOP = 1 << 62
OPERATION = PROJECTION | INTERSECTION | UNION | NEGATION | STOP

# device-side op kinds
K_OPERAND, K_PROJECTION, K_INTERSECTION, K_UNION, K_NEGATION, K_STOP = range(6)


def from_nested(nested, binary_op: bool = True) -> np.ndarray:
    """BetaE nested tuples -> postfix int64 program, '+ stop' terminated
    (query_utils.py:30-67)."""
    if not binary_op:
        raise ValueError("n-ary operations not supported")
    query = _nested_to_postfix(nested, binary_op)
    query.append(STOP)
    return np.asarray(query, dtype=np.int64)


def _nested_to_postfix(nested, binary_op=True) -> List[int]:
    query: List[int] = []
    if len(nested) == 2 and isinstance(nested[-1][-1], int):
        var, unary_ops = nested
        if isinstance(var, tuple):
            query += _nested_to_postfix(var, binary_op)
        else:
            query.append(var)
        for op in unary_ops:
            if op == -2:
                query.append(NEGATION)
            else:
                query.append(PROJECTION | op)
    else:
        if len(nested[-1]) > 1:
            vars_, nary_op = nested, INTERSECTION
        else:
            vars_, nary_op = nested[:-1], UNION
        num_args = 2 if binary_op else len(vars_)
        op = nary_op | num_args
        for i, var in enumerate(vars_):
            query += _nested_to_postfix(var)
            if i + 1 >= num_args:
                query.append(op)
    return query


def pad_queries(queries: Sequence[np.ndarray], max_length: int) -> np.ndarray:
    """Pad each program with stop to ``max_length`` (datasets_query.py:171)."""
    out = np.full((len(queries), max_length), STOP, dtype=np.int64)
    for i, q in enumerate(queries):
        if len(q) > max_length:
            raise ValueError(f"a program of {len(q)} ops does not fit {max_length}")
        out[i, : len(q)] = q
    return out


def decompose(query: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Packed int64 (B, L) -> (kind int8 (B, L), operand int32 (B, L))."""
    q = np.asarray(query, dtype=np.int64)
    kind = np.full(q.shape, K_OPERAND, dtype=np.int8)
    kind[(q & PROJECTION) > 0] = K_PROJECTION
    kind[(q & INTERSECTION) > 0] = K_INTERSECTION
    kind[(q & UNION) > 0] = K_UNION
    kind[(q & NEGATION) > 0] = K_NEGATION
    kind[(q & STOP) > 0] = K_STOP
    operand = (q & ~np.int64(OPERATION)).astype(np.int32)
    return kind, operand


def to_readable(query: np.ndarray) -> str:
    """Human-readable form of one program (query_utils.py:69-109)."""
    num_var = 0
    stack: List[str] = []
    lines: List[str] = []
    for op in np.asarray(query, dtype=np.int64):
        op = int(op)
        if not op & OPERATION:
            stack.append(str(op))
            continue
        var = chr(ord("A") + num_var)
        if op & PROJECTION:
            lines.append(f"{var} <- projection_{op & ~OPERATION}({stack.pop()})")
        elif op & INTERSECTION:
            y, x = stack.pop(), stack.pop()
            lines.append(f"{var} <- intersection({x}, {y})")
        elif op & UNION:
            y, x = stack.pop(), stack.pop()
            lines.append(f"{var} <- union({x}, {y})")
        elif op & NEGATION:
            lines.append(f"{var} <- negation({stack.pop()})")
        elif op & STOP:
            break
        stack.append(var)
        num_var += 1
    if len(stack) > 1:
        raise ValueError("More operands than expected")
    return "\n".join(lines)


def computation_graph(query: np.ndarray):
    """Computation-graph layout of one postfix program, for visualization
    (port of query_utils.py:111-164). Returns (pointer, depth, left, right):
    pointer[i] = index of the operator consuming op i's output (-1 for the
    root/unused); depth[i] = height in the tree; [left, right) = the span of
    leaf operands each operator covers."""
    q = np.asarray(query, dtype=np.int64)
    n = len(q)
    pointer = np.full(n, -1, dtype=np.int64)
    depth = np.full(n, -1, dtype=np.int64)
    width = np.full(n, -1, dtype=np.int64)
    stack: List[int] = []
    for i, op in enumerate(q):
        op = int(op)
        if not op & OPERATION:
            stack.append(i)
            depth[i], width[i] = 0, 1
        elif op & (PROJECTION | NEGATION):
            prev = stack.pop()
            pointer[prev] = i
            depth[i] = depth[prev] + 1
            width[i] = width[prev]
            stack.append(i)
        elif op & (INTERSECTION | UNION):
            prev_y, prev_x = stack.pop(), stack.pop()
            pointer[prev_y] = i
            pointer[prev_x] = i
            depth[i] = max(depth[prev_x], depth[prev_y]) + 1
            width[i] = width[prev_x] + width[prev_y]
            stack.append(i)
        elif op & STOP:
            break
    left = np.where(depth > 0, 0, -1)
    right = np.where(depth > 0, int(width.max()), -1)
    for i in reversed(range(n)):
        if pointer[i] == -1:
            continue
        ptr = pointer[i]
        depth[i] = depth[ptr] - 1
        left[i] = left[ptr] + width[ptr] - width[i]
        right[i] = left[i] + width[i]
        width[ptr] -= width[i]
    return pointer, depth, left, right


def num_projections(query: np.ndarray) -> int:
    q = np.asarray(query, dtype=np.int64)
    return int(((q & PROJECTION) > 0).sum())
