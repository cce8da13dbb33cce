"""Free-format MPS reader -> GeneralLP.

Host copy of ``smart_crossover_tpu/data/mps.py``; only the import paths
differ (the port may not import the JAX package).

Replaces the reference's dependence on Gurobi's .mps/.lp readers
(reference filehandling.py:13-98, solver_caller read_model_from_file).
Supports ROWS (N/E/L/G), COLUMNS, RHS, RANGES, BOUNDS
(UP/LO/FX/FR/MI/PL/BV/UI/LI), OBJSENSE, and G-row negation so the result fits
the GeneralLP '='/'<' sense contract.  Fixed-format quirks handled: ``$``
comments (field-initial dollar, classic netlib), omitted RHS/RANGES/BOUNDS
set names, values on value-less bound types, OBJSENSE value on its own
(indented) continuation line.
"""
from __future__ import annotations

import gzip
import re
from pathlib import Path

import numpy as np
import scipy.sparse as sp

from smart_crossover_tpu_torch.models import GeneralLP


def read_mps(path: str | Path) -> GeneralLP:
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as fh:
        lines = fh.readlines()

    section = None
    obj_row = None
    obj_offset = 0.0
    maximize = False
    row_sense: dict[str, str] = {}
    row_order: list[str] = []
    cols: dict[str, list[tuple[int, float]]] = {}
    col_order: list[str] = []
    obj_coefs: dict[str, float] = {}
    rhs: dict[str, float] = {}
    ranges: dict[str, float] = {}
    lb: dict[str, float] = {}
    ub: dict[str, float] = {}
    explicit_lb: set[str] = set()
    integer_mode = False

    def row_index(name):
        return row_order.index(name)  # only used through _rowpos cache

    _rowpos: dict[str, int] = {}

    def _is_num(tok: str) -> bool:
        try:
            float(tok)
            return True
        except ValueError:
            return False

    i = 0
    while i < len(lines):
        raw = lines[i]
        i += 1
        if not raw.strip() or raw.lstrip().startswith("*") \
                or raw.lstrip().startswith("$"):
            continue
        # '$' starting a field begins a comment (fixed-format convention,
        # common in netlib files)
        raw = re.sub(r"\s\$.*$", "", raw)
        if not raw.strip():
            continue
        if not raw[0].isspace():
            head = raw.split()
            section = head[0].upper()
            if section == "OBJSENSE" and len(head) > 1:
                maximize = head[1].upper().startswith("MAX")
            elif section == "OBJSENSE":
                # value on the next (indented) line
                while i < len(lines) and not lines[i].strip():
                    i += 1
                if i < len(lines) and lines[i][0].isspace():
                    maximize = lines[i].split()[0].upper().startswith("MAX")
                    i += 1
            continue
        tok = raw.split()
        if section == "ROWS":
            sense, name = tok[0].upper(), tok[1]
            if sense == "N":
                if obj_row is None:
                    obj_row = name
                continue
            row_sense[name] = sense
            _rowpos[name] = len(row_order)
            row_order.append(name)
        elif section == "COLUMNS":
            if len(tok) >= 3 and tok[1].upper() == "'MARKER'":
                integer_mode = tok[2].upper().strip("'") == "INTORG"
                continue
            if len(tok) >= 2 and "'MARKER'" in raw.upper():
                integer_mode = "INTORG" in raw.upper()
                continue
            col = tok[0]
            if col not in cols:
                cols[col] = []
                col_order.append(col)
                # LP relaxation: integers get the same continuous bounds
            for j in range(1, len(tok) - 1, 2):
                rname, val = tok[j], float(tok[j + 1])
                if rname == obj_row:
                    obj_coefs[col] = obj_coefs.get(col, 0.0) + val
                elif rname in _rowpos:
                    cols[col].append((_rowpos[rname], val))
        elif section == "RHS":
            # the RHS-set name may be omitted: pairs then start at tok[0]
            start = 0 if len(tok) > 1 and _is_num(tok[1]) else 1
            for j in range(start, len(tok) - 1, 2):
                rname, val = tok[j], float(tok[j + 1])
                if rname in _rowpos:
                    rhs[rname] = val
                elif rname == obj_row:
                    # RHS on the objective row: constant term, negated by
                    # MPS convention (obj = c'x - rhs)
                    obj_offset = -val
        elif section == "RANGES":
            start = 0 if len(tok) > 1 and _is_num(tok[1]) else 1
            for j in range(start, len(tok) - 1, 2):
                rname, val = tok[j], float(tok[j + 1])
                if rname in _rowpos:
                    ranges[rname] = val
        elif section == "BOUNDS":
            btype = tok[0].upper()
            rest = tok[1:]
            # the bound-set name may be omitted; value-less types (FR/MI/
            # PL/BV) may still carry an ignored numeric field
            if btype in ("UP", "LO", "FX", "UI", "LI"):
                if len(rest) >= 3:
                    col, val = rest[1], float(rest[2])
                elif len(rest) == 2:
                    col, val = rest[0], float(rest[1])
                else:
                    raise ValueError(f"{path}: bad BOUNDS line {raw!r}")
            else:
                if len(rest) >= 3:
                    col = rest[1]
                elif len(rest) == 2:
                    col = rest[0] if _is_num(rest[1]) else rest[1]
                elif len(rest) == 1:
                    col = rest[0]
                else:
                    raise ValueError(f"{path}: bad BOUNDS line {raw!r}")
                val = 0.0
            if col not in cols:
                cols[col] = []
                col_order.append(col)
            if btype == "UP":
                ub[col] = val
                if val < 0 and col not in explicit_lb:
                    lb[col] = -np.inf
            elif btype == "LO":
                lb[col] = val
                explicit_lb.add(col)
            elif btype == "FX":
                lb[col] = val
                ub[col] = val
                explicit_lb.add(col)
            elif btype == "FR":
                lb[col] = -np.inf
                ub[col] = np.inf
            elif btype == "MI":
                lb[col] = -np.inf
            elif btype == "PL":
                ub[col] = np.inf
            elif btype == "BV":
                lb[col] = 0.0
                ub[col] = 1.0
            elif btype == "UI":
                ub[col] = val
            elif btype == "LI":
                lb[col] = val
                explicit_lb.add(col)
        elif section == "ENDATA":
            break

    m0 = len(row_order)
    n = len(col_order)
    col_pos = {cname: j for j, cname in enumerate(col_order)}

    data, ri, ci = [], [], []
    for cname, entries in cols.items():
        j = col_pos[cname]
        for (r, v) in entries:
            ri.append(r)
            ci.append(j)
            data.append(v)
    A0 = sp.csr_matrix((data, (ri, ci)), shape=(m0, n))
    b0 = np.array([rhs.get(r, 0.0) for r in row_order])
    c = np.array([obj_coefs.get(cname, 0.0) for cname in col_order])
    if maximize:
        c = -c
        obj_offset = -obj_offset
    l = np.array([lb.get(cname, 0.0) for cname in col_order])
    u = np.array([ub.get(cname, np.inf) for cname in col_order])

    # normalise rows to '=' / '<' (G rows negate; ranged rows split in two)
    rows_A, rows_b, senses = [], [], []
    for k, rname in enumerate(row_order):
        s = row_sense[rname]
        bk = b0[k]
        Ak = A0.getrow(k)
        r = ranges.get(rname)
        if r is None:
            if s == "E":
                rows_A.append(Ak); rows_b.append(bk); senses.append("=")
            elif s == "L":
                rows_A.append(Ak); rows_b.append(bk); senses.append("<")
            else:  # G: negate
                rows_A.append(-Ak); rows_b.append(-bk); senses.append("<")
        else:
            # ranged row -> lo <= Ax <= hi -> two '<' rows
            if s == "L":
                lo, hi = bk - abs(r), bk
            elif s == "G":
                lo, hi = bk, bk + abs(r)
            else:  # E
                lo, hi = (bk, bk + r) if r >= 0 else (bk + r, bk)
            rows_A.append(Ak); rows_b.append(hi); senses.append("<")
            rows_A.append(-Ak); rows_b.append(-lo); senses.append("<")

    A = sp.vstack(rows_A).tocsr() if rows_A else sp.csr_matrix((0, n))
    b = np.array(rows_b)
    return GeneralLP(A=A, b=b, c=c, l=l, u=u,
                     sense=np.array(senses), name=path.stem,
                     obj_offset=obj_offset, col_names=list(col_order))
