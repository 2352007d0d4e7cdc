"""Protobuf input: length-delimited messages and compiled descriptors.

Counterpart of ``pinot_tpu/ingestion/protobuf.py`` (the reference's
``ProtoBufRecordReader`` and ``ProtoBufRecordExtractor``): the data file
holds varint-length-delimited messages; the reader loads the
``FileDescriptorSet`` named by ``descriptorFile`` (``protoc
--descriptor_set_out``), resolves ``protoClassName`` and turns each
message into a row (scalars, repeated scalars, enums by name, nested
messages as dicts). ``google.protobuf`` is imported at first use, never
with the package.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Sequence

from pinot_tpu_torch.spi.readers import (
    GenericRow,
    RecordReader,
    RecordReaderConfig,
)


def load_message_class(descriptor_file: str, message_name: str):
    """FileDescriptorSet + fully-qualified message name -> message class."""
    from google.protobuf import (
        descriptor_pb2,
        descriptor_pool,
        message_factory,
    )

    fds = descriptor_pb2.FileDescriptorSet()
    with open(descriptor_file, "rb") as f:
        fds.ParseFromString(f.read())
    pool = descriptor_pool.DescriptorPool()
    for fd in fds.file:
        pool.Add(fd)
    desc = pool.FindMessageTypeByName(message_name)
    return message_factory.GetMessageClass(desc)


def write_delimited(path: str, messages) -> None:
    """Serialize messages varint-length-delimited (writeDelimitedTo);
    protobuf's length varint is the DataTable serde's unsigned LEB128."""
    from pinot_tpu_torch.common.serde import _write_varint

    out = bytearray()
    for m in messages:
        raw = m.SerializeToString()
        _write_varint(out, len(raw))
        out += raw
    with open(path, "wb") as f:
        f.write(bytes(out))


def _message_to_dict(msg) -> Dict[str, Any]:
    """Walk DESCRIPTOR fields, not ListFields(): proto3 scalars at their
    default value (qty=0, name='') serialize as ABSENT, and the reference
    extractor still surfaces the default, not null
    (ProtoBufRecordExtractor getField semantics)."""
    out: Dict[str, Any] = {}
    for fd in msg.DESCRIPTOR.fields:
        if fd.is_repeated:
            value = getattr(msg, fd.name)
            if fd.type == fd.TYPE_MESSAGE:
                out[fd.name] = [_message_to_dict(v) for v in value]
            else:
                out[fd.name] = list(value)
        elif fd.type == fd.TYPE_MESSAGE:
            out[fd.name] = (_message_to_dict(getattr(msg, fd.name))
                            if msg.HasField(fd.name) else None)
        elif fd.type == fd.TYPE_ENUM:
            out[fd.name] = fd.enum_type.values_by_number[
                getattr(msg, fd.name)].name
        else:
            out[fd.name] = getattr(msg, fd.name)
    return out


class ProtoBufRecordReader(RecordReader):
    """Ref: ProtoBufRecordReader — config keys ``descriptorFile`` and
    ``protoClassName`` (fully-qualified message name)."""

    def init(self, data_file: str,
             fields_to_read: Optional[Sequence[str]] = None,
             config: Optional[RecordReaderConfig] = None) -> None:
        cfg = config or {}
        desc = cfg.get("descriptorFile")
        name = cfg.get("protoClassName")
        if not desc or not name:
            raise ValueError("protobuf reader needs 'descriptorFile' and "
                             "'protoClassName' in the reader config")
        self._cls = load_message_class(str(desc), str(name))
        self._path = data_file
        self._fields = list(fields_to_read) if fields_to_read else None

    def __iter__(self) -> Iterator[GenericRow]:
        from pinot_tpu_torch.common.serde import _read_varint

        with open(self._path, "rb") as f:
            buf = f.read()
        pos = 0
        while pos < len(buf):
            try:
                size, pos = _read_varint(buf, pos)
            except IndexError:
                raise ValueError(
                    f"{self._path}: truncated length varint at byte {pos}")
            if pos + size > len(buf):
                # a short tail must be LOUD: a mid-transfer truncation that
                # lands on a field boundary would otherwise parse as a
                # valid message with trailing fields silently dropped
                raise ValueError(
                    f"{self._path}: truncated message at byte {pos} "
                    f"(need {size}, have {len(buf) - pos})")
            msg = self._cls()
            msg.ParseFromString(buf[pos:pos + size])
            pos += size
            row = _message_to_dict(msg)
            if self._fields is not None:
                row = {k: row.get(k) for k in self._fields}
            yield GenericRow(row)

    def rewind(self) -> None:
        pass  # iteration re-reads the file
