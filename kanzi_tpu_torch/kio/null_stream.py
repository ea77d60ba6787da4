"""Write-discarding sink for `-o NONE` (reference: v2/io/NullOutputStream.go)."""

from __future__ import annotations


class NullOutputStream:
    """A WriteCloser that discards everything; write-after-close errors."""

    def __init__(self):
        self._closed = False
        self.written = 0

    def write(self, b) -> int:
        if self._closed:
            raise OSError("stream closed")
        self.written += len(b)
        return len(b)

    def flush(self) -> None:
        if self._closed:
            raise OSError("stream closed")

    def close(self) -> None:
        self._closed = True
