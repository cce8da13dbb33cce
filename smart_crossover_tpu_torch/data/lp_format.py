"""CPLEX/Gurobi ``.lp`` model file reader and writer -> GeneralLP.

Host copy of ``smart_crossover_tpu/data/lp_format.py``; only the import
paths differ (the port may not import the JAX package).

The reference ingests ``.lp`` files through Gurobi's reader
(reference filehandling.py:30-44, solver_caller/caller.py:57-64); this is
the in-house replacement (VERDICT.md round-1 item 7).  Supported surface —
the parts of the LP format a linear program can actually use:

* objective sense headers (``Minimize``/``Maximize`` and abbreviations),
  named or unnamed objective, constant terms;
* ``Subject To`` linear constraints: named/unnamed, ``<=``/``>=``/``=``
  (and the ``<``/``>``/``=<``/``=>`` spellings), ranged rows
  ``lo <= expr <= hi``, constraints spanning multiple lines,
  coefficientÃvariable terms with or without whitespace (``3 x`` / ``3x``);
* ``Bounds``: ``x free``, one- and two-sided bounds, ``= v`` fixing,
  ``-inf``/``infinity`` keywords;
* ``General``/``Integer`` (LP relaxation: bounds kept) and
  ``Binary`` (bounds intersected with [0, 1]) sections, ``End``.

Quadratic ``[...]`` sections, SOS and semi-continuous sections are
rejected with a clear error — this is an LP framework.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import scipy.sparse as sp

from smart_crossover_tpu_torch.models import GeneralLP

# LP-format name characters (CPLEX spec: may not start with a digit or '.')
_NAME = r"[A-Za-z!\"#$%&(),;?@_'`{}|~][A-Za-z0-9!\"#$%&(),;?@_'`{}|~.]*"
_TOKEN_RE = re.compile(
    r"\s*(?:(?P<op><=|>=|=<|=>|[<>=:+\-*\[\]^/])"
    r"|(?P<num>(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)"
    r"|(?P<name>" + _NAME + r"))")

_SENSE_MIN = ("minimize", "minimum", "min")
_SENSE_MAX = ("maximize", "maximum", "max")
_ST_FIRST = ("subject", "such", "st", "s.t.", "st.")
_BOUNDS = ("bounds", "bound")
_GENERAL = ("general", "generals", "gen", "integer", "integers")
_BINARY = ("binary", "binaries", "bin")
_UNSUPPORTED = ("sos", "semi-continuous", "semis", "semi")
_INF_NAMES = ("inf", "infinity")


class LPFormatError(ValueError):
    pass


def _tokenize_line(line: str, lineno: int):
    """Tokenize one LP-format line (comments already stripped)."""
    out = []
    pos = 0
    while pos < len(line):
        if line[pos:].strip() == "":
            break
        mo = _TOKEN_RE.match(line, pos)
        if mo is None:
            raise LPFormatError(
                f"line {lineno}: cannot tokenize {line[pos:pos+20]!r}")
        pos = mo.end()
        if mo.group("op"):
            op = mo.group("op")
            out.append(("op", {"=<": "<=", "=>": ">="}.get(op, op)))
        elif mo.group("num"):
            out.append(("num", float(mo.group("num"))))
        else:
            out.append(("name", mo.group("name")))
    return out


def read_lp(path: str | Path) -> GeneralLP:
    path = Path(path)
    if path.suffix == ".gz":
        import gzip

        with gzip.open(path, "rt") as fh:
            text = fh.read()
    else:
        text = path.read_text()
    lines = text.splitlines()

    # section split on keyword-at-line-start (the LP-format convention);
    # '\' starts a comment anywhere on a line
    section = "objective"
    maximize = False
    obj_tokens: list = []
    con_tokens: list = []
    bounds_lines: list[list] = []
    int_names: list[str] = []
    bin_names: list[str] = []
    ended = False

    for lineno, raw in enumerate(lines, 1):
        line = raw.split("\\", 1)[0]
        if not line.strip():
            continue
        toks = _tokenize_line(line, lineno)
        if not toks:
            continue
        # section keyword detection at line start
        if toks[0][0] == "name":
            kw = toks[0][1].lower()
            if kw in _SENSE_MIN or kw in _SENSE_MAX:
                maximize = kw in _SENSE_MAX
                section = "objective"
                toks = toks[1:]
            elif kw in _ST_FIRST:
                # swallow 'subject to' / 'such that' / 'st' / 's.t.'
                section = "constraints"
                toks = toks[1:]
                if toks and toks[0][0] == "name" and \
                        toks[0][1].lower() in ("to", "that"):
                    toks = toks[1:]
            elif kw in _BOUNDS:
                section = "bounds"
                toks = toks[1:]
            elif kw in _GENERAL:
                section = "general"
                toks = toks[1:]
            elif kw in _BINARY:
                section = "binary"
                toks = toks[1:]
            elif kw in _UNSUPPORTED:
                raise LPFormatError(
                    f"line {lineno}: unsupported section {kw!r} "
                    "(LP framework: linear models only)")
            elif kw == "end":
                ended = True
                break
        if not toks:
            continue
        if section == "objective":
            obj_tokens.extend(toks)
        elif section == "constraints":
            con_tokens.extend(toks)
        elif section == "bounds":
            bounds_lines.append(toks)
        elif section == "general":
            int_names.extend(t[1] for t in toks if t[0] == "name")
        elif section == "binary":
            bin_names.extend(t[1] for t in toks if t[0] == "name")
    del ended

    if any(t == ("op", "[") for t in obj_tokens + con_tokens):
        raise LPFormatError("quadratic '[...]' sections are not supported")

    var_index: dict[str, int] = {}
    var_order: list[str] = []

    def vid(name: str) -> int:
        j = var_index.get(name)
        if j is None:
            j = var_index[name] = len(var_order)
            var_order.append(name)
        return j

    def parse_expr(toks, i, coefs: dict, scale: float = 1.0):
        """Parse a linear expression starting at i; returns (i, constant).
        Stops at a relational op, a 'NAME :' label, or end of tokens."""
        const = 0.0
        sign = 1.0
        pending: float | None = None
        last_op = True   # at expression start, a +/- is a unary sign
        while i < len(toks):
            kind, val = toks[i]
            if kind == "op":
                if val in ("<=", ">=", "=", "<", ">"):
                    break
                if val in ("+", "-"):
                    if pending is not None:
                        const += sign * pending
                        pending = None
                        last_op = False
                    if last_op:   # consecutive signs accumulate
                        if val == "-":
                            sign = -sign
                    else:         # starts a new term: absolute sign
                        sign = -1.0 if val == "-" else 1.0
                    last_op = True
                    i += 1
                    continue
                if val == "*":
                    i += 1
                    continue
                raise LPFormatError(f"unexpected operator {val!r} "
                                    "in linear expression")
            if kind == "num":
                if pending is not None:
                    const += sign * pending
                    sign = 1.0
                pending = val
                last_op = False
                i += 1
                continue
            # name: a label 'NAME :' ends the expression (next constraint)
            if i + 1 < len(toks) and toks[i + 1] == ("op", ":"):
                break
            if val.lower() in _INF_NAMES:
                if pending is not None:
                    const += sign * pending
                    sign = 1.0
                pending = np.inf
                last_op = False
                i += 1
                continue
            coef = sign * (pending if pending is not None else 1.0)
            j = vid(val)
            coefs[j] = coefs.get(j, 0.0) + scale * coef
            pending = None
            sign = 1.0
            last_op = False
            i += 1
        if pending is not None:
            const += sign * pending
        return i, scale * const

    # ---- objective ----
    i = 0
    if (len(obj_tokens) >= 2 and obj_tokens[0][0] == "name"
            and obj_tokens[1] == ("op", ":")):
        i = 2
    obj_coefs: dict[int, float] = {}
    i, obj_const = parse_expr(obj_tokens, i, obj_coefs)
    if i != len(obj_tokens):
        raise LPFormatError("objective: trailing tokens "
                            f"{obj_tokens[i:i+4]!r}")

    # ---- constraints ----
    rows: list[tuple[dict, str, float]] = []   # (coefs, sense, rhs)
    t = con_tokens
    i = 0
    while i < len(t):
        if (t[i][0] == "name" and i + 1 < len(t)
                and t[i + 1] == ("op", ":")):
            i += 2   # row name (kept only positionally)
        parts: list[tuple[dict, float]] = []
        rels: list[str] = []
        while True:
            coefs: dict[int, float] = {}
            i, const = parse_expr(t, i, coefs)
            parts.append((coefs, const))
            if i < len(t) and t[i][0] == "op" and t[i][1] in (
                    "<=", ">=", "=", "<", ">"):
                rels.append({"<": "<=", ">": ">="}[t[i][1]]
                            if t[i][1] in ("<", ">") else t[i][1])
                i += 1
                continue
            break
        if not rels:
            raise LPFormatError(
                f"constraint without a relational operator near token {i}")
        if len(rels) == 1:
            (lc, lconst), (rc, rconst) = parts
            coefs = dict(lc)
            for j, v in rc.items():
                coefs[j] = coefs.get(j, 0.0) - v
            rows.append((coefs, rels[0], rconst - lconst))
        elif len(rels) == 2:
            (lo_c, lo_v), (mid, mid_v), (hi_c, hi_v) = parts
            if lo_c or hi_c:
                raise LPFormatError("ranged constraint: both outer sides "
                                    "must be constants")
            if rels == ["<=", "<="]:
                lo, hi = lo_v, hi_v
            elif rels == [">=", ">="]:
                lo, hi = hi_v, lo_v
            else:
                raise LPFormatError(f"ranged constraint with mixed "
                                    f"relations {rels}")
            rows.append((dict(mid), "<=", hi - mid_v))
            rows.append(({j: -v for j, v in mid.items()}, "<=",
                         -(lo - mid_v)))
        else:
            raise LPFormatError("constraint with more than two relations")

    # ---- bounds ----
    n_pre = len(var_order)   # vars may first appear in Bounds
    lb: dict[int, float] = {}
    ub: dict[int, float] = {}

    def signed_const(toks, i):
        sign = 1.0
        while i < len(toks) and toks[i][0] == "op" and toks[i][1] in "+-":
            if toks[i][1] == "-":
                sign = -sign
            i += 1
        if i < len(toks) and toks[i][0] == "num":
            return i + 1, sign * toks[i][1]
        if i < len(toks) and toks[i][0] == "name" and \
                toks[i][1].lower() in _INF_NAMES:
            return i + 1, sign * np.inf
        return i, None

    for toks in bounds_lines:
        i = 0
        lo = None
        i2, v = signed_const(toks, i)
        if v is not None:
            if not (i2 < len(toks) and toks[i2][0] == "op"
                    and toks[i2][1] in ("<=", ">=")):
                raise LPFormatError(f"bad bound line {toks!r}")
            if toks[i2][1] == "<=":
                lo = v
            else:   # 'hi >= x [>= lo]' (reversed form)
                i = i2 + 1
                if i >= len(toks) or toks[i][0] != "name":
                    raise LPFormatError(f"bad bound line {toks!r}")
                j = vid(toks[i][1])
                ub[j] = v
                i += 1
                if i < len(toks):
                    if toks[i] != ("op", ">="):
                        raise LPFormatError(f"bad bound line {toks!r}")
                    i2, v2 = signed_const(toks, i + 1)
                    if v2 is None:
                        raise LPFormatError(f"bad bound line {toks!r}")
                    lb[j] = v2
                continue
            i = i2 + 1
        if i >= len(toks) or toks[i][0] != "name":
            raise LPFormatError(f"bad bound line {toks!r}")
        j = vid(toks[i][1])
        i += 1
        if lo is not None:
            lb[j] = lo
        if i >= len(toks):
            continue
        kind, val = toks[i]
        if kind == "name" and val.lower() == "free":
            lb[j] = -np.inf
            ub[j] = np.inf
            continue
        if kind == "op" and val in ("<=", ">=", "="):
            i2, v = signed_const(toks, i + 1)
            if v is None:
                raise LPFormatError(f"bad bound line {toks!r}")
            if val == "<=":
                ub[j] = v
            elif val == ">=":
                lb[j] = v
            else:
                lb[j] = v
                ub[j] = v
            continue
        raise LPFormatError(f"bad bound line {toks!r}")
    del n_pre

    # ---- assemble ----
    for name in int_names:
        vid(name)
    for name in bin_names:
        vid(name)
    n = len(var_order)
    m = len(rows)
    c = np.zeros(n)
    for j, v in obj_coefs.items():
        c[j] = v
    data, ri, ci = [], [], []
    b = np.zeros(m)
    senses = []
    for k, (coefs, rel, rhs) in enumerate(rows):
        for j, v in coefs.items():
            ri.append(k)
            ci.append(j)
            data.append(v if rel != ">=" else -v)
        b[k] = rhs if rel != ">=" else -rhs
        senses.append("=" if rel == "=" else "<")
    A = sp.csr_matrix((data, (ri, ci)), shape=(m, n))
    l = np.zeros(n)
    u = np.full(n, np.inf)
    for j, v in lb.items():
        l[j] = v
    for j, v in ub.items():
        # unlike MPS, the CPLEX/Gurobi LP format does NOT free the lower
        # bound on a negative upper bound: the default l=0 stands (the
        # model may simply be infeasible)
        u[j] = v
    for name in bin_names:
        j = var_index[name]
        l[j] = max(l[j], 0.0)
        u[j] = min(u[j], 1.0)
    obj_offset = obj_const
    if maximize:
        c = -c
        obj_offset = -obj_offset
    return GeneralLP(A=A, b=b, c=c, l=l, u=u, sense=np.array(senses),
                     name=path.stem, obj_offset=obj_offset,
                     col_names=list(var_order))


def write_lp(lp: GeneralLP, path: str | Path) -> None:
    """Write a GeneralLP as an LP-format file (round-trips with read_lp)."""
    path = Path(path)
    names = getattr(lp, "col_names", None) or [
        f"x{j}" for j in range(lp.n)]
    A = sp.csr_matrix(lp.A)
    out = [f"\\ Problem: {lp.name or path.stem}", "Minimize"]

    def expr(cols, vals, const=0.0):
        terms = []
        for j, v in zip(cols, vals):
            if v == 0.0:
                continue
            sign = "-" if v < 0 else "+"
            terms.append(f"{sign} {abs(v):.17g} {names[j]}")
        if const:
            sign = "-" if const < 0 else "+"
            terms.append(f"{sign} {abs(const):.17g}")
        if not terms:
            return "0 " + names[0] if names else "0"
        s = " ".join(terms)
        return s[2:] if s.startswith("+ ") else s

    out.append(" obj: " + expr(range(lp.n), np.asarray(lp.c).ravel(),
                               lp.obj_offset))
    out.append("Subject To")
    for k in range(lp.m):
        row = A.getrow(k)
        rel = "=" if lp.sense[k] == "=" else "<="
        out.append(f" c{k}: {expr(row.indices, row.data)} {rel} "
                   f"{lp.b[k]:.17g}")
    out.append("Bounds")
    for j in range(lp.n):
        lo, hi = lp.l[j], lp.u[j]
        if lo == 0.0 and np.isposinf(hi):
            continue
        if np.isneginf(lo) and np.isposinf(hi):
            out.append(f" {names[j]} free")
        elif lo == hi:
            out.append(f" {names[j]} = {lo:.17g}")
        else:
            lo_s = "-inf" if np.isneginf(lo) else f"{lo:.17g}"
            hi_s = "+inf" if np.isposinf(hi) else f"{hi:.17g}"
            out.append(f" {lo_s} <= {names[j]} <= {hi_s}")
    out.append("End")
    path.write_text("\n".join(out) + "\n")
