"""The plain reference decoder against the program's streams.

The program's streams are written here on its host C++ path, which its
own tests hold byte for byte to the device path's."""

import pytest

from portbench import corpus, reference
from portbench.check import layouts, work

import kanzi_tpu_torch as kt
from kanzi_tpu_torch.xxhash import xxhash32 as program_xxhash32

CONFIGS = {"range": ("LZ", "RANGE"), "ans1": ("NONE", "ANS1")}


@pytest.fixture(scope="module")
def data():
    return corpus.synth_corpus((3 << 20) + 12345, 2 ** 32 + 9, 1)


@pytest.mark.parametrize("codec", sorted(CONFIGS))
def test_reference_decodes_every_block(codec, data):
    transform, entropy = CONFIGS[codec]
    size = 1 << 20
    blob = kt.compress(data, transform=transform, entropy=entropy, block_size=size,
                       jobs=2, checksum=32, device=None)
    header, frames = reference.parse(blob)
    assert header.block_size == size and header.checksum_bits == 32
    assert header.size == len(data) and len(frames) == 4
    for f in frames:
        original = data[f.index * size:(f.index + 1) * size]
        out, stored = reference.decode_block(blob, header, f)
        assert out == original
        assert stored == reference.xxhash32(original)
    # the work a decode needs: every block's payload and output
    (w,) = [work(lay) for lay in layouts([blob])]
    assert len(w) == 4 and all(e == header.entropy for e, _, _ in w)
    assert sum(p for _, p, _ in w) < len(blob)


def test_small_and_degenerate_blocks():
    for data in (b"x" * 5000, bytes(range(256)) * 40, b"ab" * 3, b"\x00" * 70000):
        for transform, entropy in CONFIGS.values():
            blob = kt.compress(data, transform=transform, entropy=entropy, block_size=65536,
                               checksum=32, device=None)
            header, frames = reference.parse(blob)
            out = b"".join(reference.decode_block(blob, header, f)[0] for f in frames)
            assert out == data


def test_a_flipped_checksum_bit_is_found_where_the_reader_reads_it():
    data = corpus.synth_corpus(200_000, 3, 3)
    blob = kt.compress(data, transform="LZ", entropy="RANGE", block_size=65536,
                       checksum=32, device=None)
    header, frames = reference.parse(blob)
    head = reference.block_head(blob, header, frames[1])
    bad = bytearray(blob)
    bad[head.checksum_pos >> 3] ^= 0x80 >> (head.checksum_pos & 7)
    out, stored = reference.decode_block(bytes(bad), header, frames[1])
    assert out == data[65536:131072] and stored != reference.xxhash32(out)
    with pytest.raises(kt.KanziError) as e:
        kt.decompress(bytes(bad), device=None)
    assert e.value.code == reference.ERR_CRC_CHECK


@pytest.mark.parametrize("data", [b"", b"a", b"abc", b"0123456789abcdef", bytes(range(256)) * 3 + b"xyz"])
def test_xxhash32(data):
    assert reference.xxhash32(data, 0) == program_xxhash32(data, 0)
    assert reference.xxhash32(data) == program_xxhash32(data, reference.MAGIC)


def test_xxhash32_published_vectors():
    assert reference.xxhash32(b"", 0) == 0x02CC5D05
    assert reference.xxhash32(b"a", 0) == 0x550D7456
    assert reference.xxhash32(b"abc", 0) == 0x32D153FF


def test_a_broken_stream_is_a_format_error():
    blob = kt.compress(b"hello world" * 1000, transform="LZ", entropy="RANGE",
                       checksum=32, device=None)
    with pytest.raises(reference.FormatError):
        reference.parse(blob[:-3] if blob[-1] else blob[:10])
    with pytest.raises(reference.FormatError):
        reference.parse(b"XANZ" + blob[4:])
