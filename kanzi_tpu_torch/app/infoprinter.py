"""InfoPrinter: verbosity-driven per-block event reporting.

Behavioral parity with the reference listener (v2/app/InfoPrinter.go:54-425):

- three printer types: COMPRESSION, DECOMPRESSION, INFO;
- per-block correlation of the 4 stage timestamps (before/after transform,
  before/after entropy) into the v>=4 line
  ``Block N: s0 => s1 [d1 ms] => s2 [d2 ms]`` with the compression-only
  integer ``(P%)`` ratio and the optional ``  [hash]`` suffix;
- the ordered phase (AFTER_ENTROPY when compressing, BEFORE_ENTROPY when
  decompressing — per the constructor InfoPrinter.go:93-102; the in-code
  Go comment at :144-145 says BEFORE_TRANSFORM but the code sets
  BEFORE_ENTROPY, and the code wins) is held in a pending map and emitted
  strictly in block-id order;
- v>=5 prints every event, with ``[d ms]`` stage-duration suffixes on the
  threshold events;
- AFTER_HEADER_DECODING prints the raw-text header block at v in [3,5) and
  the JSON event at v>=5;
- INFO mode (the ``-y`` CLI surface) renders the fixed-width header table,
  emitting the column-title row exactly once per printer.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from ..core import Event, EventType, Listener

# printer types (reference InfoPrinter.go:36-42)
COMPRESSION = 0
DECOMPRESSION = 1
INFO = 2


def _format_size(size: float) -> str:
    """Human size, reference formatSize (InfoPrinter.go:409-425)."""
    if size >= float(1 << 30):
        return f"{size / (1 << 30):.2f} GiB"
    if size >= float(1 << 20):
        return f"{size / (1 << 20):.2f} MiB"
    if size >= float(1 << 10):
        return f"{size / (1 << 10):.2f} KiB"
    return f"{size:f}"


class _BlockInfo:
    __slots__ = ("time0", "time1", "time2", "time3", "stage0", "stage1")

    def __init__(self):
        self.time0 = self.time1 = self.time2 = self.time3 = 0.0
        self.stage0 = self.stage1 = 0


class InfoPrinter(Listener):
    def __init__(self, verbosity: int, info_type, out=None,
                 first_block_id: int = 1):
        # accept the historic EventType-based constructor too
        if info_type == EventType.COMPRESSION_START:
            info_type = COMPRESSION
        elif info_type == EventType.DECOMPRESSION_START:
            info_type = DECOMPRESSION
        self.info_type = int(info_type) & 3
        self.verbosity = verbosity
        self.out = out or sys.stderr
        if self.info_type == COMPRESSION:
            self.thresholds = (
                EventType.COMPRESSION_START, EventType.BEFORE_TRANSFORM,
                EventType.AFTER_TRANSFORM, EventType.BEFORE_ENTROPY,
                EventType.AFTER_ENTROPY, EventType.COMPRESSION_END)
            self.ordered_phase = EventType.AFTER_ENTROPY
        else:
            self.thresholds = (
                EventType.DECOMPRESSION_START, EventType.BEFORE_ENTROPY,
                EventType.AFTER_ENTROPY, EventType.BEFORE_TRANSFORM,
                EventType.AFTER_TRANSFORM, EventType.DECOMPRESSION_END)
            self.ordered_phase = EventType.BEFORE_ENTROPY
        self._lock = threading.Lock()
        self._infos: dict[int, _BlockInfo] = {}
        self._ordered_pending: dict[int, Event] = {}
        self._last_emitted = first_block_id - 1
        self._header_info_rows = 0

    # -- entry point -------------------------------------------------------

    def process_event(self, evt: Event) -> None:
        if self.info_type == INFO:
            self._process_header_info(evt)
            return
        if evt.type == self.ordered_phase:
            self._process_ordered_phase(evt)
            return
        self._process_event_ordered(evt)

    # -- ordered-phase pending map (InfoPrinter.go:123-148) ----------------

    def _process_ordered_phase(self, evt: Event) -> None:
        with self._lock:
            self._ordered_pending[evt.block_id] = evt
        while True:
            with self._lock:
                next_id = self._last_emitted + 1
                nxt = self._ordered_pending.pop(next_id, None)
                if nxt is None:
                    return
                self._last_emitted = next_id
            self._process_event_ordered(nxt)

    # -- main state machine (InfoPrinter.go:150-309) -----------------------

    def _process_event_ordered(self, evt: Event) -> None:
        bid = evt.block_id
        t = evt.time or time.time()
        if evt.type == self.thresholds[1]:
            bi = _BlockInfo()
            bi.time0 = t
            bi.stage0 = evt.size
            with self._lock:
                self._infos[bid] = bi
            if self.verbosity >= 5:
                print(str(evt), file=self.out)
        elif evt.type == self.thresholds[2]:
            with self._lock:
                bi = self._infos.get(bid)
            if bi is not None:
                bi.time1 = t
                if self.verbosity >= 5:
                    d = int(1000 * (bi.time1 - bi.time0))
                    print(f"{evt} [{d} ms]", file=self.out)
        elif evt.type == self.thresholds[3]:
            with self._lock:
                bi = self._infos.get(bid)
            if bi is not None:
                bi.time2 = t
                bi.stage1 = evt.size
                if self.verbosity >= 5:
                    d = int(1000 * (bi.time2 - bi.time1))
                    print(f"{evt} [{d} ms]", file=self.out)
        elif evt.type == self.thresholds[4]:
            with self._lock:
                bi = self._infos.get(bid)
                if bi is None or self.verbosity < 3:
                    return
                del self._infos[bid]
            bi.time3 = t
            d1 = int(1000 * (bi.time1 - bi.time0))
            d2 = int(1000 * (bi.time3 - bi.time2))
            stage2 = evt.size
            if self.verbosity >= 5:
                print(f"{evt} [{d2} ms]", file=self.out)
            if self.verbosity >= 4:
                msg = (f"Block {bid}: {bi.stage0} => {bi.stage1} "
                       f"[{d1} ms] => {stage2} [{d2} ms]")
                if self.info_type == COMPRESSION and bi.stage0 != 0:
                    msg += f" ({stage2 * 100 // bi.stage0}%)"
                if evt.hash_type:
                    msg += f"  [{evt.hash:x}]"
                print(msg, file=self.out)
        elif (evt.type == EventType.AFTER_HEADER_DECODING
              and self.verbosity >= 3):
            info = evt.info
            if info is None:
                return
            if self.verbosity >= 5:
                print(str(evt), file=self.out)
            else:
                lines = [f"", f"Bitstream version: {info.bs_version}"]
                c = info.checksum_size
                lines.append("Block checksum: "
                             + ("NONE" if c == 0 else f"{c} bits"))
                lines.append(f"Block size: {info.block_size} bytes")
                e = info.entropy_type or "no"
                lines.append(f"Using {e} entropy codec (stage 1)")
                tr = info.transform_type or "no"
                lines.append(f"Using {tr} transform (stage 2)")
                if info.original_size >= 0:
                    lines.append(f"Original size: {info.original_size} byte(s)")
                print("\n".join(lines) + "\n", file=self.out)
        elif self.verbosity >= 5:
            print(str(evt), file=self.out)

    # -- INFO mode: the -y header table (InfoPrinter.go:311-407) -----------

    def _process_header_info(self, evt: Event) -> None:
        if self.verbosity == 0 or evt.type != EventType.AFTER_HEADER_DECODING:
            return
        info = evt.info
        if info is None:
            return
        parts = []
        if self._header_info_rows == 0:
            hdr = ("\n|     File Name      |Ver|Check|Block Size"
                   "|  File Size | Orig. Size | Ratio ")
            if self.verbosity >= 4:
                hdr += "| Entropy|        Transforms        "
            parts.append(hdr + "|\n")
        name = info.input_name.rsplit(os.sep, 1)[-1]
        if len(name) > 20:
            name = name[:18] + ".."
        parts.append(f"|{name:<20}|{info.bs_version:>3}"
                     f"|{info.checksum_size:>5}|{info.block_size:>10}|")
        if info.file_size >= 0:
            parts.append(f"{_format_size(float(info.file_size)):>12}|")
        if info.original_size >= 0:
            parts.append(f"{_format_size(float(info.original_size)):>12}|")
        if info.file_size >= 0 and info.original_size >= 0:
            ratio = float(info.file_size) / float(info.original_size)
            parts.append(f" {ratio:.3f} |")
        else:
            parts.append("  N/A  |")
        if self.verbosity >= 4:
            parts.append(f"{info.entropy_type:>8}|")
            tr = info.transform_type
            if len(tr) > 26:
                tr = tr[:24] + ".."
            parts.append(f"{tr:>26}|")
        print("".join(parts), file=self.out)
        self._header_info_rows += 1
