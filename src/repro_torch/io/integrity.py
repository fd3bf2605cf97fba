"""Chunk integrity: CRC32C (Castagnoli) checksums and the error type
verification raises.

The checksum is the storage-industry standard CRC32C (polynomial
0x1EDC6F41, reflected — the same function iSCSI, ext4 metadata, and
NVMe end-to-end protection use), implemented as a pure-Python
table-driven loop because this container bakes its dependency set (no
``crc32c``/``google-crc32c`` wheels). The loop costs ~0.1 s/MB, which
is irrelevant at the KB chunk sizes the fault batteries run and
acceptable for checkpoint manifests; integrity is therefore an OPT-IN
knob (``IOConfig.integrity``) rather than an always-on tax — see the
``repro_torch.io`` design note for the lifecycle.

``IntegrityError`` subclasses ``IOError`` so every existing fault path
(request futures, coordinator cleanup, executor unwind) treats a
checksum mismatch exactly like a failed syscall: loudly.
"""
from __future__ import annotations

_POLY = 0x82F63B78          # 0x1EDC6F41 bit-reflected


def _build_table():
    table = []
    for n in range(256):
        crc = n
        for _ in range(8):
            crc = (crc >> 1) ^ _POLY if crc & 1 else crc >> 1
        table.append(crc)
    return tuple(table)


_TABLE = _build_table()


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of ``data`` (bytes-like; memoryviews are read without
    copying). Pass a previous return value as ``crc`` to checksum a
    stream incrementally."""
    crc ^= 0xFFFFFFFF
    table = _TABLE
    for b in memoryview(data).cast("B"):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class IntegrityError(IOError):
    """Stored bytes do not match their recorded checksum (silent
    corruption, a torn write, or a stale sidecar). Raised on READ —
    the moment garbage would otherwise enter training — and classified
    as transient for one retry round (a torn in-flight read heals; bytes
    corrupted on the device keep mismatching and propagate loudly)."""
