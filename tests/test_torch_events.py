"""Block events of the port's device paths against kanzi_tpu's: the port's
Writer and Reader with device="cpu" (the device engines on the kernels'
plain versions, `jobs` blocks a batch) send the events that kanzi_tpu's
send on its host path with a listener attached: type, block id, size,
hash, hash type and BLOCK_INFO's message, times excluded. Per block in
order, BLOCK_INFO and the decoder's ordered phase (BEFORE_ENTROPY) in
global order, and an InfoPrinter's block lines in order."""

import io
import os
import re

import numpy as np
import pytest

from kanzi_tpu.app.infoprinter import InfoPrinter as RefPrinter
from kanzi_tpu.kio import Reader as RefReader, Writer as RefWriter
from kanzi_tpu_torch import _kernels
from kanzi_tpu_torch.app.infoprinter import COMPRESSION, DECOMPRESSION, InfoPrinter
from kanzi_tpu_torch.core import EventType
from kanzi_tpu_torch.kio import Reader, Writer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 16384
# the device engine and its plain kernels, per entropy type
KERNELS = {"HUFFMAN": ("pack_lanes", "decode_lanes"), "ANS0": ("ans_encode", "ans_decode"),
           "ANS1": ("ans_encode", "ans_decode"), "RANGE": ("range_encode", "range_decode")}

with open(os.path.join(ROOT, "SURVEY.md"), "rb") as _fh:
    _TEXT = _fh.read()


def _data() -> bytes:
    """Two text blocks, a random block the gate copies, a tail block."""
    rng = np.random.default_rng(17)
    return (_TEXT[:2 * BLOCK] + rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes()
            + _TEXT[2 * BLOCK:2 * BLOCK + 5000])


class Recorder:
    def __init__(self):
        self.events = []

    def process_event(self, evt):
        self.events.append((int(evt.type), evt.block_id, evt.size, evt.hash,
                            int(evt.hash_type), evt.msg))


def _by_block(events):
    blocks = {}
    for e in events:
        blocks.setdefault(e[1], []).append(e)
    return blocks


def _lines(text):
    return [re.sub(r"\d+ ms", "N ms", ln) for ln in text.splitlines()
            if re.match(r"Block \d+: ", ln)]


def _encode(writer_cls, data, entropy, jobs, checksum, printer, **kw):
    rec, sink = Recorder(), io.BytesIO()
    w = writer_cls(sink, transform="LZ", entropy=entropy, block_size=BLOCK, jobs=jobs,
                   checksum=checksum, file_size=len(data), ctx={"skipBlocks": True}, **kw)
    assert w.add_listener(rec) and w.add_listener(printer)
    for i in range(0, len(data), 10000):  # writes smaller than a batch
        w.write(data[i:i + 10000])
    w.close()
    return sink.getvalue(), rec.events


def _decode(reader_cls, blob, jobs, printer, **kw):
    rec = Recorder()
    r = reader_cls(io.BytesIO(blob), jobs=jobs, **kw)
    assert r.add_listener(rec)
    r.add_listener(printer)
    out = r.read_all()
    r.close()
    return out, rec.events


@pytest.mark.parametrize("jobs", [1, 4])
@pytest.mark.parametrize("entropy,checksum", [("HUFFMAN", 32), ("ANS0", 64),
                                              ("ANS1", 0), ("RANGE", 32)])
def test_device_paths_send_the_reference_events(entropy, checksum, jobs):
    data = _data()
    ref_log, log = io.StringIO(), io.StringIO()
    want_blob, want = _encode(RefWriter, data, entropy, jobs, checksum,
                              RefPrinter(4, COMPRESSION, out=ref_log))
    _kernels.reset_counts()
    blob, got = _encode(Writer, data, entropy, jobs, checksum,
                        InfoPrinter(4, COMPRESSION, out=log), device="cpu")
    # the listener left the entropy stage on the device path
    assert _kernels.plain_calls[KERNELS[entropy][0]] > 0
    assert blob == want_blob
    assert _by_block(got) == _by_block(want)
    info = [e for e in got if e[0] == EventType.BLOCK_INFO]
    assert info == [e for e in want if e[0] == EventType.BLOCK_INFO]
    assert [e[1] for e in info] == [1, 2, 3, 4]
    assert '"skipFlags":"11111111"' in info[2][5]   # the copied block
    if jobs == 1:
        assert got == want
    assert _lines(log.getvalue()) == _lines(ref_log.getvalue())
    assert len(_lines(log.getvalue())) == 4

    ref_log, log = io.StringIO(), io.StringIO()
    out, want = _decode(RefReader, blob, jobs, RefPrinter(4, DECOMPRESSION, out=ref_log))
    assert out == data
    _kernels.reset_counts()
    out, got = _decode(Reader, blob, jobs, InfoPrinter(4, DECOMPRESSION, out=log),
                       device="cpu")
    assert out == data
    assert _kernels.plain_calls[KERNELS[entropy][1]] > 0
    assert _by_block(got) == _by_block(want)
    assert [e for e in got if e[0] == EventType.BEFORE_ENTROPY] == \
        [e for e in want if e[0] == EventType.BEFORE_ENTROPY]
    if jobs == 1:
        assert got == want
    assert _lines(log.getvalue()) == _lines(ref_log.getvalue())
    assert len(_lines(log.getvalue())) == 4


def test_listener_failures_never_affect_the_stream():
    class Raising:
        def process_event(self, evt):
            raise RuntimeError("listener failure")

    data = _data()
    want = RefWriter(None, transform="LZ", entropy="HUFFMAN", block_size=BLOCK, jobs=4,
                     file_size=len(data))
    want.write(data)
    want.close()
    w = Writer(None, transform="LZ", entropy="HUFFMAN", block_size=BLOCK, jobs=4,
               file_size=len(data), device="cpu")
    assert w.add_listener(Raising())
    w.write(data)
    w.close()
    assert w.getvalue() == want.getvalue()
    r = Reader(w.getvalue(), jobs=4, device="cpu")
    r.add_listener(Raising())
    assert r.read_all() == data


@pytest.mark.parametrize("device", [None, "cpu"])
def test_a_listener_leaves_the_stream_unchanged(device):
    """Blocks of random 2-bit symbols under DNA+LZ: the alias codec (DNA)
    vetoes itself, and the data type it detected keeps LZ off the block.
    The host per-block path a listener takes (device=None) and the device
    path give the stream the one-call native path gives without a listener,
    which is kanzi_tpu's stream without a listener."""
    rng = np.random.default_rng(21)
    data = _TEXT[:BLOCK] + rng.integers(0, 4, 3 * BLOCK, dtype=np.uint8).tobytes()
    kw = dict(transform="DNA+LZ", entropy="HUFFMAN", block_size=BLOCK, jobs=4,
              file_size=len(data))
    want = RefWriter(None, **kw)
    want.write(data)
    want.close()
    for listen in (False, True):
        w = Writer(None, device=device, **kw)
        if listen:
            w.add_listener(Recorder())
        w.write(data)
        w.close()
        assert w.getvalue() == want.getvalue(), listen
