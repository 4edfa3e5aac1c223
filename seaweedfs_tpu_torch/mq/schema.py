"""Schema'd MQ messages: typed records, binary values, columnar arrays.

Counterpart of the reference's weed/mq/schema/ (schema.go RecordType +
fieldMap, schema_builder.go, struct_to_schema.go reflection inference,
to_parquet_value.go / to_parquet_levels.go columnarization), redesigned
for this framework's array-native columnar tier (mq/log_store.py seals
segments into .npz):

  * :class:`RecordType` — ordered named fields; scalars BOOL/INT32/
    INT64/DOUBLE/BYTES/STRING, LIST-of-scalar, nested RECORD;
  * `infer_record_type(value)` — the struct_to_schema analogue for a
    Python dict instance;
  * `encode_record` / `decode_record` — compact schema-driven binary
    (no field tags on the wire: the schema is the contract, registered
    with the topic, so values cost bytes only for data);
  * `records_to_columns` — decoded records → numpy column arrays
    (dotted paths for nested records), the to_parquet_* analogue that
    drops straight into the .npz tier and array-side analytics.

The schema rides the topic configuration (ConfigureTopic
record_type_json; brokers persist + serve it), so any consumer can
decode without out-of-band coordination — the reference stores its
RecordType on the topic's conf the same way.

The port's copy of seaweedfs_tpu/mq/schema.py.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field as dc_field

import numpy as np

BOOL = "bool"
INT32 = "int32"
INT64 = "int64"
DOUBLE = "double"
BYTES = "bytes"
STRING = "string"

_SCALARS = (BOOL, INT32, INT64, DOUBLE, BYTES, STRING)
_FIXED = {BOOL: "<b", INT32: "<i", INT64: "<q", DOUBLE: "<d"}


class SchemaError(ValueError):
    pass


@dataclass(frozen=True)
class Field:
    name: str
    type: "str | RecordType"
    is_list: bool = False


@dataclass(frozen=True)
class RecordType:
    fields: tuple[Field, ...]

    def __init__(self, fields):
        object.__setattr__(self, "fields", tuple(fields))
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise SchemaError(f"duplicate field names in {names}")
        for f in self.fields:
            if isinstance(f.type, RecordType):
                if f.is_list:
                    raise SchemaError("lists of records are not supported")
            elif f.type not in _SCALARS:
                raise SchemaError(f"unknown field type {f.type!r}")

    def field(self, name: str) -> Field | None:
        for f in self.fields:
            if f.name == name:
                return f
        return None

    # ---- JSON form (what rides the topic config) -------------------------
    def to_json(self) -> str:
        return json.dumps(self._to_obj(), separators=(",", ":"))

    def _to_obj(self) -> list:
        out = []
        for f in self.fields:
            t = f.type._to_obj() if isinstance(f.type, RecordType) else f.type
            out.append({"name": f.name, "type": t, "list": f.is_list})
        return out

    @classmethod
    def from_json(cls, blob: str) -> "RecordType":
        try:
            obj = json.loads(blob)
        except json.JSONDecodeError as e:
            raise SchemaError(f"bad schema json: {e}") from e
        return cls._from_obj(obj)

    @classmethod
    def _from_obj(cls, obj) -> "RecordType":
        if not isinstance(obj, list):
            raise SchemaError("schema must be a field list")
        fields = []
        for f in obj:
            try:
                t = f["type"]
                if isinstance(t, list):
                    t = cls._from_obj(t)
                fields.append(Field(str(f["name"]), t, bool(f.get("list"))))
            except (KeyError, TypeError, AttributeError) as e:
                # structurally malformed field objects are SCHEMA errors,
                # not internal crashes — callers catch SchemaError
                raise SchemaError(f"malformed schema field {f!r}: {e}") from e
        return cls(fields)


def infer_record_type(value: dict) -> RecordType:
    """struct_to_schema.go for a dict instance: bool/int/float/bytes/str
    map to scalars, dicts nest, lists take their first element's type."""
    fields = []
    for name, v in value.items():
        fields.append(_infer_field(str(name), v))
    return RecordType(fields)


def _infer_field(name: str, v) -> Field:
    if isinstance(v, list):
        if not v:
            raise SchemaError(f"cannot infer type of empty list {name!r}")
        inner = _infer_field(name, v[0])
        if inner.is_list or isinstance(inner.type, RecordType):
            raise SchemaError(f"unsupported nested list at {name!r}")
        return Field(name, inner.type, is_list=True)
    if isinstance(v, bool):
        return Field(name, BOOL)
    if isinstance(v, int):
        return Field(name, INT64)
    if isinstance(v, float):
        return Field(name, DOUBLE)
    if isinstance(v, bytes):
        return Field(name, BYTES)
    if isinstance(v, str):
        return Field(name, STRING)
    if isinstance(v, dict):
        return Field(name, infer_record_type(v))
    raise SchemaError(f"cannot infer schema for {name!r}: {type(v).__name__}")


# ---------------------------------------------------------------------------
# binary values
# ---------------------------------------------------------------------------


def _enc_scalar(t: str, v, out: list) -> None:
    if t in _FIXED:
        try:
            out.append(struct.pack(_FIXED[t], v))
        except struct.error as e:
            raise SchemaError(f"value {v!r} does not fit {t}") from e
        return
    if t == STRING:
        if not isinstance(v, str):
            raise SchemaError(f"expected str, got {type(v).__name__}")
        b = v.encode()
    else:  # BYTES
        if not isinstance(v, (bytes, bytearray, memoryview)):
            raise SchemaError(f"expected bytes, got {type(v).__name__}")
        b = bytes(v)
    out.append(struct.pack("<I", len(b)))
    out.append(b)


def _dec_scalar(t: str, buf: bytes, off: int):
    if t in _FIXED:
        s = struct.Struct(_FIXED[t])
        (v,) = s.unpack_from(buf, off)
        if t == BOOL:
            v = bool(v)
        return v, off + s.size
    (ln,) = struct.unpack_from("<I", buf, off)
    off += 4
    raw = buf[off : off + ln]
    if len(raw) != ln:
        raise SchemaError("truncated value")
    return (raw.decode() if t == STRING else raw), off + ln


def encode_record(rt: RecordType, value: dict) -> bytes:
    """Schema-driven binary: fields in schema order, a presence bitmap
    up front (missing fields decode as None), no per-field tags."""
    out: list[bytes] = []
    present = 0
    for i, f in enumerate(rt.fields):
        if value.get(f.name) is not None:
            present |= 1 << i
    nbytes = (len(rt.fields) + 7) // 8
    out.append(present.to_bytes(nbytes, "little"))
    extra = set(value) - {f.name for f in rt.fields}
    if extra:
        raise SchemaError(f"fields not in schema: {sorted(extra)}")
    for i, f in enumerate(rt.fields):
        if not (present >> i) & 1:
            continue
        v = value[f.name]
        if isinstance(f.type, RecordType):
            b = encode_record(f.type, v)
            out.append(struct.pack("<I", len(b)))
            out.append(b)
        elif f.is_list:
            if not isinstance(v, list):
                raise SchemaError(f"{f.name} must be a list")
            out.append(struct.pack("<I", len(v)))
            for item in v:
                _enc_scalar(f.type, item, out)
        else:
            _enc_scalar(f.type, v, out)
    return b"".join(out)


def decode_record(rt: RecordType, buf: bytes) -> dict:
    try:
        return _decode_record(rt, buf)
    except (struct.error, IndexError) as e:
        # truncated/garbage buffers (e.g. raw publishes to a schema'd
        # topic) surface as the module's declared error type
        raise SchemaError(f"undecodable record: {e}") from e


def _decode_record(rt: RecordType, buf: bytes) -> dict:
    nbytes = (len(rt.fields) + 7) // 8
    present = int.from_bytes(buf[:nbytes], "little")
    off = nbytes
    out: dict = {}
    for i, f in enumerate(rt.fields):
        if not (present >> i) & 1:
            out[f.name] = None
            continue
        if isinstance(f.type, RecordType):
            (ln,) = struct.unpack_from("<I", buf, off)
            off += 4
            out[f.name] = _decode_record(f.type, buf[off : off + ln])
            off += ln
        elif f.is_list:
            (n,) = struct.unpack_from("<I", buf, off)
            off += 4
            items = []
            for _ in range(n):
                v, off = _dec_scalar(f.type, buf, off)
                items.append(v)
            out[f.name] = items
        else:
            out[f.name], off = _dec_scalar(f.type, buf, off)
    if off != len(buf):
        raise SchemaError(f"trailing bytes after record ({len(buf) - off})")
    return out


# ---------------------------------------------------------------------------
# columnar (the to_parquet_* analogue for the npz tier)
# ---------------------------------------------------------------------------

_NP = {BOOL: np.bool_, INT32: np.int32, INT64: np.int64, DOUBLE: np.float64}


def records_to_columns(
    rt: RecordType, records: list[dict], prefix: str = ""
) -> dict[str, np.ndarray]:
    """Decoded records -> {dotted.field.path: column array}.

    Fixed-width scalars become typed arrays (+ a ``<name>.present`` bool
    mask when any value is missing); strings/bytes/lists become object
    arrays.  Nested records flatten with dotted paths — the shape the
    columnar log tier and array-side scans consume."""
    cols: dict[str, np.ndarray] = {}
    for f in rt.fields:
        path = prefix + f.name
        vals = [r.get(f.name) if r else None for r in records]
        if isinstance(f.type, RecordType):
            cols.update(records_to_columns(f.type, vals, path + "."))
            continue
        if f.is_list or f.type in (BYTES, STRING):
            cols[path] = np.asarray(vals, dtype=object)
            continue
        mask = np.asarray([v is not None for v in vals], dtype=bool)
        fill = {BOOL: False, INT32: 0, INT64: 0, DOUBLE: np.nan}[f.type]
        cols[path] = np.asarray(
            [fill if v is None else v for v in vals], dtype=_NP[f.type]
        )
        if not mask.all():
            cols[path + ".present"] = mask
    return cols
