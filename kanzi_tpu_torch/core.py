"""Core constants, error codes and interfaces of the kanzi_tpu_torch codec.

Re-designed from scratch for the KANZ v6 bitstream. Error codes and interface
contracts mirror the reference spec (kanzi-go v2/Definitions.go:25-179) so that
library users migrating from the reference find the same surface.
"""

from __future__ import annotations

import enum


# Process error codes (reference: v2/Definitions.go:25-46)
ERR_MISSING_PARAM = 1
ERR_BLOCK_SIZE = 2
ERR_INVALID_CODEC = 3
ERR_CREATE_COMPRESSOR = 4
ERR_CREATE_DECOMPRESSOR = 5
ERR_OUTPUT_IS_DIR = 6
ERR_OVERWRITE_FILE = 7
ERR_CREATE_FILE = 8
ERR_CREATE_BITSTREAM = 9
ERR_OPEN_FILE = 10
ERR_READ_FILE = 11
ERR_WRITE_FILE = 12
ERR_PROCESS_BLOCK = 13
ERR_CREATE_CODEC = 14
ERR_INVALID_FILE = 15
ERR_STREAM_VERSION = 16
ERR_CREATE_STREAM = 17
ERR_INVALID_PARAM = 18
ERR_CRC_CHECK = 19
ERR_UNKNOWN = 127


class KanziError(Exception):
    """Error carrying one of the ERR_* codes."""

    def __init__(self, msg: str, code: int = ERR_UNKNOWN):
        super().__init__(f"{msg} (code {code})")
        self.msg = msg
        self.code = code


# Event types (reference: v2/Event.go:23-60)
class EventType(enum.IntEnum):
    COMPRESSION_START = 0
    DECOMPRESSION_START = 1
    BEFORE_TRANSFORM = 2
    AFTER_TRANSFORM = 3
    BEFORE_ENTROPY = 4
    AFTER_ENTROPY = 5
    COMPRESSION_END = 6
    DECOMPRESSION_END = 7
    AFTER_HEADER_DECODING = 8
    BLOCK_INFO = 9


class HashType(enum.IntEnum):
    NONE = 0
    SIZE_32 = 1
    SIZE_64 = 2


class HeaderInfo:
    """Parsed stream-header facts carried by an AFTER_HEADER_DECODING event
    (reference: v2/Event.go HeaderInfo / NewEventFromHeaderInfo). Sizes are
    -1 when unknown (headerless / streaming input)."""

    __slots__ = ("bs_version", "checksum_size", "block_size", "entropy_type",
                 "transform_type", "original_size", "file_size", "input_name")

    def __init__(self, bs_version=0, checksum_size=0, block_size=0,
                 entropy_type="", transform_type="", original_size=-1,
                 file_size=-1, input_name=""):
        self.bs_version = bs_version
        self.checksum_size = checksum_size
        self.block_size = block_size
        self.entropy_type = entropy_type
        self.transform_type = transform_type
        self.original_size = original_size
        self.file_size = file_size
        self.input_name = input_name


class Event:
    """Progress event emitted by the stream container (reference: v2/Event.go:62-204)."""

    __slots__ = ("type", "block_id", "size", "hash", "hash_type", "time",
                 "msg", "info")

    def __init__(self, evt_type, block_id, size=0, hash_=0,
                 hash_type=HashType.NONE, time_=0.0, msg=None, info=None):
        self.type = EventType(evt_type)
        self.block_id = block_id
        self.size = size
        self.hash = hash_
        self.hash_type = HashType(hash_type)
        self.time = time_
        self.msg = msg
        self.info = info

    def __str__(self):
        if self.msg is not None:
            return self.msg
        hash_field = ""
        if self.hash_type != HashType.NONE:
            hash_field = f', "hash":"{self.hash:x}"'
        return (f'{{ "type":"{self.type.name}", "id":{self.block_id},'
                f' "size":{self.size}{hash_field} }}')


class Listener:
    """Event listener interface."""

    def process_event(self, evt: Event) -> None:  # pragma: no cover
        raise NotImplementedError


# Stream container constants (reference: v2/io/CompressedStream.go:42-54)
BITSTREAM_TYPE = 0x4B414E5A  # "KANZ"
BITSTREAM_FORMAT_VERSION = 6
COPY_BLOCK_MASK = 0x80
TRANSFORMS_MASK = 0x10
MIN_BITSTREAM_BLOCK_SIZE = 1024
MAX_BITSTREAM_BLOCK_SIZE = 1024 * 1024 * 1024
SMALL_BLOCK_SIZE = 15
MAX_CONCURRENCY = 64
