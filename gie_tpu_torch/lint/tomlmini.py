"""Minimal TOML-subset reader for the lint configs.

The analyzers depend on nothing outside the standard library's ``ast``,
and Python 3.10 has no stdlib ``tomllib``, so the lint configs restrict
themselves to the subset this reader handles:

  - ``[table]`` / ``[a.b]`` headers and ``[[array-of-tables]]``
  - ``key = value`` with bare or quoted keys
  - values: strings ("..." or '...'), integers, floats, booleans, and
    (possibly multiline) arrays of those

Comments (#) and blank lines are ignored. Anything outside the subset
raises ValueError with the offending line — a lint config that cannot be
read must fail the build loudly, not silently relax the rules.
"""

from __future__ import annotations


def _strip_comment(line: str) -> str:
    out = []
    in_str: str | None = None
    i = 0
    while i < len(line):
        c = line[i]
        if in_str:
            if c == "\\" and in_str == '"':
                out.append(line[i: i + 2])
                i += 2
                continue
            if c == in_str:
                in_str = None
        elif c in ("'", '"'):
            in_str = c
        elif c == "#":
            break
        out.append(c)
        i += 1
    return "".join(out).strip()


def _parse_scalar(tok: str, where: str):
    tok = tok.strip()
    if not tok:
        raise ValueError(f"{where}: empty value")
    if tok[0] == '"':
        if len(tok) < 2 or tok[-1] != '"':
            raise ValueError(f"{where}: unterminated string {tok!r}")
        body = tok[1:-1]
        return body.encode("latin-1", "backslashreplace").decode(
            "unicode_escape")
    if tok[0] == "'":
        if len(tok) < 2 or tok[-1] != "'":
            raise ValueError(f"{where}: unterminated string {tok!r}")
        return tok[1:-1]
    if tok == "true":
        return True
    if tok == "false":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        raise ValueError(f"{where}: unsupported value {tok!r}") from None


def _split_array_items(body: str, where: str) -> list[str]:
    items, cur, in_str = [], [], None
    for c in body:
        if in_str:
            cur.append(c)
            if c == in_str:
                in_str = None
        elif c in ("'", '"'):
            in_str = c
            cur.append(c)
        elif c == ",":
            items.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    if in_str:
        raise ValueError(f"{where}: unterminated string in array")
    items.append("".join(cur))
    return [s.strip() for s in items if s.strip()]


def _parse_key(tok: str, where: str) -> str:
    tok = tok.strip()
    if tok and tok[0] in ("'", '"'):
        if len(tok) < 2 or tok[-1] != tok[0]:
            raise ValueError(f"{where}: bad quoted key {tok!r}")
        return tok[1:-1]
    if not tok:
        raise ValueError(f"{where}: empty key")
    return tok


def loads(text: str, name: str = "<toml>") -> dict:
    root: dict = {}
    table = root
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        where = f"{name}:{i + 1}"
        line = _strip_comment(lines[i])
        i += 1
        if not line:
            continue
        if line.startswith("[[") and line.endswith("]]"):
            path = [_parse_key(p, where) for p in line[2:-2].split(".")]
            parent = root
            for part in path[:-1]:
                parent = parent.setdefault(part, {})
            arr = parent.setdefault(path[-1], [])
            if not isinstance(arr, list):
                raise ValueError(f"{where}: {path[-1]!r} is not a table array")
            table = {}
            arr.append(table)
            continue
        if line.startswith("[") and line.endswith("]"):
            path = [_parse_key(p, where) for p in line[1:-1].split(".")]
            parent = root
            for part in path[:-1]:
                parent = parent.setdefault(part, {})
            table = parent.setdefault(path[-1], {})
            if not isinstance(table, dict):
                raise ValueError(f"{where}: {path[-1]!r} is not a table")
            continue
        if "=" not in line:
            raise ValueError(f"{where}: expected key = value, got {line!r}")
        key, _, val = line.partition("=")
        key = _parse_key(key, where)
        val = val.strip()
        if val.startswith("["):
            # Array, possibly spanning lines until the closing bracket.
            while True:
                depth = 0
                in_str = None
                complete = False
                for c in val:
                    if in_str:
                        if c == in_str:
                            in_str = None
                    elif c in ("'", '"'):
                        in_str = c
                    elif c == "[":
                        depth += 1
                    elif c == "]":
                        depth -= 1
                        if depth == 0:
                            complete = True
                if complete:
                    break
                if i >= len(lines):
                    raise ValueError(f"{where}: unterminated array")
                val += " " + _strip_comment(lines[i])
                i += 1
            body = val.strip()[1:-1]
            table[key] = [
                _parse_scalar(tok, where)
                for tok in _split_array_items(body, where)
            ]
        else:
            table[key] = _parse_scalar(val, where)
    return root


def load(path) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return loads(f.read(), name=str(path))
