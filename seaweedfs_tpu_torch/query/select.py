"""A small SELECT engine over JSON-lines documents.

Counterpart of the reference's weed/query/ (the S3-Select-ish JSON
evaluator): supports

    SELECT *                     | SELECT s.a, s.b.c
    FROM S3Object s              (alias optional; [*] suffix tolerated)
    WHERE s.field op literal     (op: = != < <= > >=)  [optional]
    LIMIT n                      [optional]

Dotted paths traverse nested objects.  Input is JSON Lines (one object
per line — the shape the reference's parquet/log tiers emit); output is
JSON Lines of the projected records.

The port's copy of seaweedfs_tpu/query/select.py: byte-identical output
on the same query and input.
"""

from __future__ import annotations

import json
import re


class SelectError(ValueError):
    pass


_SELECT_RE = re.compile(
    r"^\s*select\s+(?P<proj>.+?)\s+from\s+s3object(?:\[\*\])?"
    r"(?:\s+(?:as\s+)?(?P<alias>[a-z_][a-z0-9_]*))?"
    r"(?:\s+where\s+(?P<where>.+?))?"
    r"(?:\s+limit\s+(?P<limit>\d+))?\s*;?\s*$",
    re.IGNORECASE | re.DOTALL,
)
_COND_RE = re.compile(
    r"^\s*(?P<path>[\w.$\[\]]+)\s*(?P<op>=|!=|<>|<=|>=|<|>)\s*(?P<lit>.+?)\s*$"
)


def _parse_literal(text: str):
    text = text.strip()
    if (text.startswith("'") and text.endswith("'")) or (
        text.startswith('"') and text.endswith('"')
    ):
        return text[1:-1]
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low == "null":
        return None
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError as e:
        raise SelectError(f"bad literal {text!r}") from e


def _strip_alias(path: str, alias: str | None) -> list[str]:
    parts = path.split(".")
    # "_1" is a row alias only when fields follow (s3object[*]._1.name);
    # bare "_1" is a positional CSV column, not an alias
    if parts and (
        parts[0] == alias
        or parts[0] == "s3object"
        or (parts[0] == "_1" and len(parts) > 1)
    ):
        parts = parts[1:]
    if not parts:
        raise SelectError(f"empty field path {path!r}")
    return parts


def _lookup(obj, parts: list[str]):
    for p in parts:
        if not isinstance(obj, dict) or p not in obj:
            return None
        obj = obj[p]
    return obj


def parse_select(sql: str):
    m = _SELECT_RE.match(sql)
    if m is None:
        raise SelectError(f"unsupported expression: {sql!r}")
    alias = (m.group("alias") or "").lower() or None
    proj_raw = m.group("proj").strip()
    if proj_raw == "*":
        projection = None
    else:
        projection = [
            _strip_alias(p.strip(), alias)
            for p in proj_raw.split(",")
            if p.strip()
        ]
        if not projection:
            raise SelectError("empty projection")
    predicate = None
    if m.group("where"):
        c = _COND_RE.match(m.group("where"))
        if c is None:
            raise SelectError(f"unsupported WHERE: {m.group('where')!r}")
        path = _strip_alias(c.group("path"), alias)
        op = c.group("op")
        lit = _parse_literal(c.group("lit"))

        def predicate(obj, path=path, op=op, lit=lit):
            val = _lookup(obj, path)
            try:
                if op == "=":
                    return val == lit
                if op in ("!=", "<>"):
                    return val != lit
                if val is None or lit is None:
                    return False
                if op == "<":
                    return val < lit
                if op == "<=":
                    return val <= lit
                if op == ">":
                    return val > lit
                return val >= lit
            except TypeError:
                return False  # cross-type ordering: no match

    limit = int(m.group("limit")) if m.group("limit") else None
    return projection, predicate, limit


_INT_RE = re.compile(r"^-?(0|[1-9]\d*)$")
_FLOAT_RE = re.compile(r"^-?\d+\.\d+$")


def _coerce(text: str):
    """CSV cells are text; coerce cells that are *canonically* numeric so
    WHERE age > 30 works — but only when the value round-trips exactly
    ('00420' zip codes, '1_0', '1e3', '1.50' version strings all stay
    strings, so string predicates and SELECT * CSV round-trips are
    lossless)."""
    if _INT_RE.match(text):
        return int(text)
    if _FLOAT_RE.match(text):
        f = float(text)
        if repr(f) == text:  # '1.50' -> 1.5 would not round-trip
            return f
    return text


def _iter_json_rows(body: bytes):
    for lineno, line in enumerate(body.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        try:
            yield json.loads(line)
        except json.JSONDecodeError as e:
            raise SelectError(f"input line {lineno} is not JSON: {e}") from e


def _iter_csv_rows(body: bytes, delimiter: str, header: str):
    """CSV input (reference s3 Select CSV InputSerialization): header
    'USE' keys rows by the first line, 'IGNORE'/'NONE' key by _1.._N
    (AWS's positional column names; NONE — the S3 default — treats
    line 1 as data)."""
    import csv
    import io

    reader = csv.reader(io.StringIO(body.decode()), delimiter=delimiter)
    header = (header or "NONE").upper()
    columns: list[str] | None = None
    # the header is the first NON-EMPTY row, not physical line 0 — a
    # leading blank line must not demote the real header to data
    awaiting_header = header in ("USE", "IGNORE")
    for cells in reader:
        if not cells:
            continue
        if awaiting_header:
            awaiting_header = False
            if header == "USE":
                columns = cells
            continue
        if columns is None:
            yield {f"_{j + 1}": _coerce(c) for j, c in enumerate(cells)}
        else:
            yield {
                col: _coerce(c)
                for col, c in zip(columns, cells)
            }


def execute_select(
    sql: str,
    body: bytes,
    *,
    input_format: str = "json",
    output_format: str | None = None,
    field_delimiter: str = ",",
    file_header_info: str = "NONE",  # the S3 API default
) -> bytes:
    """Run the query; input/output are JSON lines or CSV
    (reference weed/query/ JSON path + s3api Select CSV serialization)."""
    projection, predicate, limit = parse_select(sql)
    output_format = output_format or input_format
    rows_in = (
        _iter_csv_rows(body, field_delimiter, file_header_info)
        if input_format == "csv"
        else _iter_json_rows(body)
    )
    rows_out: list[dict] = []
    for obj in rows_in:
        if predicate is not None and not predicate(obj):
            continue
        if projection is None:
            rows_out.append(obj)
        else:
            row = {}
            for parts in projection:
                val = _lookup(obj, parts)
                node = row
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = val
            rows_out.append(row)
        if limit is not None and len(rows_out) >= limit:
            break

    if output_format == "csv":
        import csv
        import io

        def flatten(row: dict, prefix: str = "") -> dict:
            out: dict = {}
            for k, v in row.items():
                if isinstance(v, dict):
                    out.update(flatten(v, f"{prefix}{k}."))
                elif isinstance(v, (list, tuple)):
                    # arrays have no CSV shape: compact JSON, never repr
                    out[f"{prefix}{k}"] = json.dumps(v, separators=(",", ":"))
                else:
                    out[f"{prefix}{k}"] = v
            return out

        flat = [flatten(r) for r in rows_out]
        # column set = union across all rows, ordered by first appearance
        # (taking only the first row's keys silently drops later fields)
        columns: list[str] = []
        for row in flat:
            for k in row:
                if k not in columns:
                    columns.append(k)
        buf = io.StringIO()
        writer = csv.writer(buf, delimiter=field_delimiter, lineterminator="\n")
        for row in flat:
            writer.writerow(
                ["" if row.get(c) is None else row.get(c) for c in columns]
            )
        return buf.getvalue().encode()
    out = [json.dumps(r, separators=(",", ":")) for r in rows_out]
    return ("\n".join(out) + "\n" if out else "").encode()
