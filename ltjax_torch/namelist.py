"""Fortran namelist parser (reader for ``LTRANS.data``-style files).

The reference engine reads every run parameter from a single Fortran
namelist file via ``getParams`` (parameter_module.f90 [conf: H], see
SURVEY.md SS5.6).  This module is a small hand-written parser for the
namelist subset that file uses: ``&group key = value, ... /`` records
with integer, real (including ``d``/``D`` exponents), logical
(``.TRUE.``/``.FALSE.``/``T``/``F``) and quoted-string values, plus
``!``-comments.  Arrays (``key = 1, 2, 3``) parse to Python lists.

No third-party dependency (no f90nml).  The port's own copy of
``ltjax.namelist``, the same parser.
"""

from __future__ import annotations

import re
from typing import Any, Dict

_LOGICAL_TRUE = {".true.", ".t.", "t", "true"}
_LOGICAL_FALSE = {".false.", ".f.", "f", "false"}

# A value token: quoted string, or a bare token (number/logical).
_TOKEN_RE = re.compile(
    r"""\s*(?:(?P<sq>'(?:[^']|'')*')|(?P<dq>"(?:[^"]|"")*")|(?P<bare>[^\s,/!]+))\s*,?"""
)


def _convert(tok: str) -> Any:
    """Convert one bare namelist token to a Python value."""
    low = tok.lower()
    if low in _LOGICAL_TRUE:
        return True
    if low in _LOGICAL_FALSE:
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    # Fortran real: allow d/D exponent markers.
    ftok = re.sub(r"[dD]", "e", tok)
    try:
        return float(ftok)
    except ValueError:
        pass
    return tok  # leave as raw string (unquoted path etc.)


def _strip_comment(line: str) -> str:
    """Remove a trailing ! comment, respecting quoted strings."""
    out = []
    in_sq = in_dq = False
    for ch in line:
        if ch == "'" and not in_dq:
            in_sq = not in_sq
        elif ch == '"' and not in_sq:
            in_dq = not in_dq
        elif ch == "!" and not in_sq and not in_dq:
            break
        out.append(ch)
    return "".join(out)


def parse_namelist(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse namelist text into ``{group: {key: value}}``.

    Group and key names are lower-cased (Fortran is case-insensitive).
    Scalar values stay scalars; multi-value assignments become lists.
    """
    groups: Dict[str, Dict[str, Any]] = {}
    # Join physical lines, dropping comments.
    body = "\n".join(_strip_comment(l) for l in text.splitlines())

    # Find group records: standard ``&group ... /`` or the DEC-style
    # ``$group ... $end`` that the reference's LTRANS.data uses.
    pos = 0
    while True:
        m = re.search(r"[&$](\w+)", body[pos:])
        if not m:
            break
        gname = m.group(1).lower()
        if gname == "end":  # stray $end terminator, not a group opener
            pos += m.end()
            continue
        start = pos + m.end()
        # record ends at a '/' or '$end' that is not inside quotes
        end = start
        skip = 1
        in_sq = in_dq = False
        while end < len(body):
            ch = body[end]
            if ch == "'" and not in_dq:
                in_sq = not in_sq
            elif ch == '"' and not in_sq:
                in_dq = not in_dq
            elif ch == "/" and not in_sq and not in_dq:
                break
            elif ch == "$" and not in_sq and not in_dq:
                if body[end:end + 4].lower() == "$end":
                    skip = 4
                    break
                break  # next $group opens => implicit end of this record
            end += 1
        record = body[start:end]
        pos = end + skip

        grp = groups.setdefault(gname, {})
        # Split on key = values pairs.
        for km in re.finditer(r"(\w+(?:\([^)]*\))?)\s*=", record):
            key = km.group(1).lower()
            vstart = km.end()
            nxt = re.search(r"\w+(?:\([^)]*\))?\s*=", record[vstart:])
            vend = vstart + nxt.start() if nxt else len(record)
            raw = record[vstart:vend]
            vals = []
            for tm in _TOKEN_RE.finditer(raw):
                if tm.group("sq") is not None:
                    vals.append(tm.group("sq")[1:-1].replace("''", "'"))
                elif tm.group("dq") is not None:
                    vals.append(tm.group("dq")[1:-1].replace('""', '"'))
                else:
                    vals.append(_convert(tm.group("bare")))
            if len(vals) == 1:
                grp[key] = vals[0]
            elif vals:
                grp[key] = vals
    return groups


def read_namelist(path: str) -> Dict[str, Dict[str, Any]]:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return parse_namelist(f.read())


def flatten(groups: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Merge all groups into one flat dict (later groups win)."""
    flat: Dict[str, Any] = {}
    for g in groups.values():
        flat.update(g)
    return flat
